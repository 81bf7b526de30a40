"""Open-loop load generation: replay a trace against a live gateway
(counterpart of ``keystone_tpu/loadgen/runner.py``).

MLPerf-LoadGen-style discipline (Reddi et al., *MLPerf Inference
Benchmark*): requests are issued on the GENERATOR's clock — the
recorded/synthesized inter-arrival gaps scaled by ``speed`` — never
paced by responses. A slow or melting server does not slow the
arrival process down; it accumulates outstanding requests until the
gateway's admission control sheds, which is exactly the regime the
chaos invariants are about. (A closed-loop driver would politely wait
and measure nothing but itself.)

Two targets behind one interface:

- ``HttpTarget`` — POSTs ``/predict`` to a running ``GatewayServer``;
  typed shed/expired/closed responses (429/504/503 with an
  ``overloaded`` body) classify as typed sheds, anything else
  non-2xx is an UNTYPED failure (the invariant checker's cardinal
  sin), and a transport timeout is a LOST request (an admitted future
  that never resolved — the other cardinal sin).
- ``InprocTarget`` — drives a ``Gateway`` object directly
  (``predict().result()``), same classification; ``serve-loadgen
  --self-gateway`` and in-process drills use it, with no socket.

The ``LoadReport`` collects one ``RequestRecord`` per issued request
plus the chaos timeline (``FaultWindow``s the driver armed) and the
readiness-recovery probe result; ``loadgen/invariants.py`` turns it
into a verdict."""

from __future__ import annotations

import dataclasses
import itertools
import json
import logging
import queue
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from keystone_tpu_torch.loadgen.trace import TraceEvent
from keystone_tpu_torch.observability.tracing import TRACE_RESPONSE_HEADER

logger = logging.getLogger(__name__)

# statuses a record can end in; "lost" = no terminal outcome within
# the wait bound — the invariant checker fails the run on any of them
TYPED_SHED_REASONS = (
    "queue_full", "slo_pressure", "deadline", "expired", "closed",
)

# wait past the request's own deadline before a request is declared
# lost (generous: a lost future should be the server's bug, never the
# client's impatience)
LOST_SLACK_S = 30.0

# the gateway's server-side ceiling for waiting on one prediction
# (gateway/http.py RESULT_TIMEOUT_S): the HTTP client's lost-bound
# must EXCEED it, or a request the server eventually resolves with a
# typed answer gets misclassified as lost
SERVER_RESULT_BOUND_S = 60.0


@dataclasses.dataclass
class RequestRecord:
    """One issued request's terminal outcome."""

    index: int
    t_send: float                 # seconds from run start (actual)
    t_sched: float                # seconds from run start (scheduled)
    status: str                   # ok | shed | error | lost
    n_rows: int = 1
    latency_s: Optional[float] = None
    code: Optional[int] = None    # HTTP status (http target only)
    reason: Optional[str] = None  # typed shed reason / error detail
    untyped: bool = False         # True for non-typed failures
    # the server's X-Keystone-Trace echo (success AND typed shed):
    # the record's handle into /debugz?trace_id= forensics — what the
    # verdict's exemplars surface for the worst/lost/untyped requests
    trace_id: Optional[str] = None

    @property
    def behind_s(self) -> float:
        """How late the open-loop scheduler issued this request."""
        return self.t_send - self.t_sched


@dataclasses.dataclass
class FaultWindow:
    """One chaos interval the driver armed (run-relative seconds)."""

    point: str
    t_arm: float
    t_clear: Optional[float] = None
    spec: Optional[Dict[str, Any]] = None


class LoadReport:
    """Everything one experiment produced: per-request records, the
    chaos timeline, and the post-fault readiness probe."""

    def __init__(self):
        self.records: List[RequestRecord] = []
        self.fault_windows: List[FaultWindow] = []
        self.duration_s: float = 0.0
        self.issued: int = 0
        # seconds from the LAST fault clearing to /readyz green again;
        # None = never recovered within the probe bound (or no probe)
        self.ready_recovery_s: Optional[float] = None
        self.ready_probed: bool = False
        self._lock = threading.Lock()

    def add(self, rec: RequestRecord) -> None:
        with self._lock:
            self.records.append(rec)

    def by_status(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for r in self.records:
            counts[r.status] = counts.get(r.status, 0) + 1
        return counts

    def latencies(
        self,
        t_min: float = 0.0,
        t_max: float = float("inf"),
        status: str = "ok",
    ) -> List[float]:
        """Latencies of ``status`` requests SENT in [t_min, t_max)."""
        return [
            r.latency_s
            for r in self.records
            if r.status == status
            and r.latency_s is not None
            and t_min <= r.t_send < t_max
        ]

    def p99(
        self, t_min: float = 0.0, t_max: float = float("inf")
    ) -> Optional[float]:
        xs = self.latencies(t_min, t_max)
        if not xs:
            return None
        return float(np.percentile(xs, 99))

    def stats(self) -> Dict[str, Any]:
        by = self.by_status()
        total = len(self.records)
        shed = by.get("shed", 0)
        return {
            "issued": self.issued,
            "resolved": total,
            "by_status": by,
            "untyped_failures": sum(1 for r in self.records if r.untyped),
            "lost": by.get("lost", 0),
            "shed_rate": round(shed / total, 4) if total else None,
            "duration_s": round(self.duration_s, 3),
            "max_behind_ms": round(
                max((r.behind_s for r in self.records), default=0.0)
                * 1e3, 2,
            ),
            "fault_windows": [
                dataclasses.asdict(w) for w in self.fault_windows
            ],
            "ready_recovery_s": self.ready_recovery_s,
        }


def _payload_for(event: TraceEvent, default_shape, dtype=np.float32) -> np.ndarray:
    """Deterministic request data: (n_rows, *shape) standard normal,
    seeded by the event's index-ish identity (its timestamp bits) so a
    replay issues identical bytes. ``dtype=np.uint8`` draws uniform
    bytes instead (raw images for a ``--device-featurize`` gateway)."""
    shape = tuple(event.shape) if event.shape else tuple(default_shape)
    seed = int(abs(event.ts) * 1e6) & 0x7FFFFFFF
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.uint8:
        return rng.integers(0, 256, (event.n_rows,) + shape, dtype=np.uint8)
    return rng.standard_normal(
        (event.n_rows,) + shape
    ).astype(np.float32)


# the most label rows one /feedback POST carries
FEEDBACK_BATCH_ROWS = 256


class FeedbackSender:
    """Labeled-feedback side channel for lifecycle drills: a sampled
    fraction of the payloads the generator POSTs also get labeled by
    a ``labeler`` (e.g. ``lifecycle/teacher.teacher_labels``) and
    POSTed to the gateway's ``/feedback`` — off the load path, on one
    background thread, with a bounded drop-newest queue so a slow
    labeler or a melting server can never backpressure the open-loop
    arrival clock. Sampling is the same deterministic integer-part
    arithmetic as the canary router: ``fraction`` of offers, evenly
    spaced, no RNG. The thread labels and POSTs whatever is queued when
    it wakes as one batch (up to ``FEEDBACK_BATCH_ROWS`` rows), so delivery
    keeps up with the offers instead of paying a labeler call and an
    HTTP round trip for each."""

    def __init__(
        self,
        base_url: str,
        labeler,
        fraction: float = 0.25,
        max_queue: int = 64,
        timeout_s: float = 30.0,
    ):
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        self.base_url = base_url.rstrip("/")
        self._labeler = labeler
        self.fraction = float(fraction)
        self.timeout_s = float(timeout_s)
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._sent = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._errors = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._drain,
            name="keystone-loadgen-feedback",
            daemon=True,
        )
        self._thread.start()

    def offer(self, xs: np.ndarray) -> None:
        """Maybe-enqueue one request's instances (called on the issue
        path — MUST stay O(1) and non-blocking)."""
        seq = next(self._seq)
        f = self.fraction
        if f <= 0.0 or int((seq + 1) * f) <= int(seq * f):
            return
        try:
            self._q.put_nowait(xs)
        except queue.Full:
            with self._lock:
                self._dropped += 1

    def _drain(self) -> None:
        while not (self._stop.is_set() and self._q.empty()):
            try:
                batch = [self._q.get(timeout=0.2)]
            except queue.Empty:
                continue
            rows = batch[0].shape[0]
            while rows < FEEDBACK_BATCH_ROWS:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
                rows += batch[-1].shape[0]
            try:
                xs = np.concatenate(batch) if len(batch) > 1 else batch[0]
                ys = np.asarray(self._labeler(xs))
                body = json.dumps(
                    {"instances": xs.tolist(), "labels": ys.tolist()}
                ).encode("utf-8")
                req = urllib.request.Request(
                    self.base_url + "/feedback",
                    data=body,
                    headers={"Content-Type": "application/json"},
                    method="POST",
                )
                with urllib.request.urlopen(
                    req, timeout=self.timeout_s
                ) as resp:
                    resp.read()
                with self._lock:
                    self._sent += int(xs.shape[0])
            except Exception:
                with self._lock:
                    self._errors += len(batch)  # offers, as one POST each

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "sent": self._sent,
                "dropped": self._dropped,
                "errors": self._errors,
            }

    def close(self, timeout: float = 15.0) -> Dict[str, int]:
        """Flush the queue, stop the thread, return final stats."""
        self._stop.set()
        self._thread.join(timeout)
        return self.stats()


class HttpTarget:
    """POST /predict (or /predict/<model> for events carrying a model
    id) against a live gateway frontend. ``feedback`` (a
    ``FeedbackSender``) mirrors a sampled fraction of payloads to
    POST /feedback as labeled examples — the lifecycle drill's
    traffic-correlated label stream."""

    def __init__(
        self,
        base_url: str,
        default_shape: Sequence[int] = (8,),
        feedback: Optional[FeedbackSender] = None,
        dtype=np.float32,
    ):
        self.base_url = base_url.rstrip("/")
        self.default_shape = tuple(default_shape)
        self.feedback = feedback
        self.dtype = dtype

    def send(self, event: TraceEvent) -> RequestRecord:
        # index/t_* are stamped by the generator; this fills the rest
        xs = _payload_for(event, self.default_shape, self.dtype)
        if self.feedback is not None:
            self.feedback.offer(xs)
        doc: Dict[str, Any] = {"instances": xs.tolist()}
        if event.deadline_ms is not None:
            doc["deadline_ms"] = event.deadline_ms
        body = json.dumps(doc).encode("utf-8")
        # outlast the server's own result bound plus slack: "lost"
        # must mean the SERVER never answered, not that this client
        # hung up first
        timeout = SERVER_RESULT_BOUND_S + 15.0 + (
            event.deadline_ms / 1e3 if event.deadline_ms else 0.0
        )
        path = (
            "/predict/" + event.model if event.model else "/predict"
        )
        req = urllib.request.Request(
            self.base_url + path,
            data=body,
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                resp.read()
                latency = time.perf_counter() - t0
                return RequestRecord(
                    0, 0.0, 0.0, "ok", n_rows=event.n_rows,
                    latency_s=latency, code=resp.status,
                    trace_id=resp.headers.get(TRACE_RESPONSE_HEADER),
                )
        except urllib.error.HTTPError as e:
            latency = time.perf_counter() - t0
            try:
                err = json.loads(e.read() or b"{}")
            except ValueError:
                err = {}
            reason = err.get("reason") or err.get("error")
            typed = (
                e.code in (429, 503, 504)
                and err.get("error") == "overloaded"
                and err.get("reason") in TYPED_SHED_REASONS
            )
            return RequestRecord(
                0, 0.0, 0.0, "shed" if typed else "error",
                n_rows=event.n_rows, latency_s=latency, code=e.code,
                reason=reason, untyped=not typed,
                # typed sheds carry the trace header too — by design:
                # a shed client needs the forensic handle MOST
                trace_id=e.headers.get(TRACE_RESPONSE_HEADER),
            )
        except Exception as e:
            # transport timeout / connection drop: the request was
            # issued and never got a terminal answer — a LOST request
            return RequestRecord(
                0, 0.0, 0.0, "lost", n_rows=event.n_rows,
                reason=f"{type(e).__name__}: {e}",
            )

    def ready(self) -> bool:
        try:
            with urllib.request.urlopen(
                self.base_url + "/readyz", timeout=5
            ) as resp:
                return resp.status == 200
        except Exception:
            return False

    def arm_fault(self, spec: Dict[str, Any]) -> None:
        """Arm a fault point IN THE SERVER PROCESS via POST /chaosz."""
        self._chaosz({"arm": spec})

    def disarm_fault(self, point: str) -> None:
        self._chaosz({"disarm": point})

    def fired_count(self, point: str) -> Optional[int]:
        """Lifetime fire count of ``point`` in the server process
        (the did-the-fault-actually-fire audit); None if /chaosz is
        unreachable."""
        try:
            with urllib.request.urlopen(
                self.base_url + "/chaosz", timeout=10
            ) as resp:
                doc = json.loads(resp.read())
            return int(doc.get("fired_total", {}).get(point, 0))
        except Exception:
            return None

    def _chaosz(self, doc: Dict[str, Any]) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.base_url + "/chaosz",
            data=json.dumps(doc).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())


class InprocTarget:
    """Drive a ``Gateway`` object directly (no socket)."""

    def __init__(self, gateway, default_shape: Sequence[int] = (8,)):
        self.gateway = gateway
        self.default_shape = tuple(default_shape)

    def send(self, event: TraceEvent) -> RequestRecord:
        from concurrent.futures import TimeoutError as _FutTimeout

        from keystone_tpu_torch.gateway.admission import Overloaded

        xs = _payload_for(event, self.default_shape)
        timeout = LOST_SLACK_S + (
            event.deadline_ms / 1e3 if event.deadline_ms else 0.0
        )
        t0 = time.perf_counter()
        futures = []
        # mirror the HTTP header capture: the admission layer rides
        # each future's trace id; the first instance's id stands for
        # the request in the verdict's exemplars
        def _tid():
            return next(
                (
                    tid
                    for tid in (
                        getattr(f, "trace_id", None) for f in futures
                    )
                    if tid
                ),
                None,
            )

        try:
            for row in xs:
                futures.append(
                    self.gateway.predict(
                        row, deadline_ms=event.deadline_ms
                    )
                )
            for f in futures:
                f.result(timeout=timeout)
        except Overloaded as e:
            for f in futures:
                f.cancel()
            return RequestRecord(
                0, 0.0, 0.0, "shed", n_rows=event.n_rows,
                latency_s=time.perf_counter() - t0, reason=e.reason,
                trace_id=_tid(),
            )
        except (_FutTimeout, TimeoutError):
            for f in futures:
                f.cancel()
            return RequestRecord(
                0, 0.0, 0.0, "lost", n_rows=event.n_rows,
                reason=f"future unresolved after {timeout:.0f}s",
                trace_id=_tid(),
            )
        except Exception as e:
            for f in futures:
                f.cancel()
            return RequestRecord(
                0, 0.0, 0.0, "error", n_rows=event.n_rows,
                latency_s=time.perf_counter() - t0,
                reason=f"{type(e).__name__}: {e}", untyped=True,
                trace_id=_tid(),
            )
        return RequestRecord(
            0, 0.0, 0.0, "ok", n_rows=event.n_rows,
            latency_s=time.perf_counter() - t0, trace_id=_tid(),
        )

    def ready(self) -> bool:
        return bool(self.gateway.ready)

    def arm_fault(self, spec: Dict[str, Any]) -> None:
        from keystone_tpu_torch.loadgen import faults

        spec = dict(spec)
        point = spec.pop("point")
        faults.arm(point, **spec)

    def disarm_fault(self, point: str) -> None:
        from keystone_tpu_torch.loadgen import faults

        faults.disarm(point)

    def fired_count(self, point: str) -> Optional[int]:
        from keystone_tpu_torch.loadgen import faults

        return faults.get_injector().fired_count(point)


@dataclasses.dataclass
class FaultPlan:
    """Arm ``spec`` at ``at_s`` into the run, clear after ``for_s``.
    The spec's own ``for_s`` is set too, so the server self-disarms
    even if the driver dies mid-experiment."""

    spec: Dict[str, Any]
    at_s: float
    for_s: Optional[float] = None


class LoadGenerator:
    """Replay events open-loop against one target.

    ``max_outstanding`` bounds the in-flight worker threads — NOT a
    pacing mechanism: when the bound is hit the scheduler still holds
    the arrival clock and records how far behind it fell
    (``behind_s`` per record, ``max_behind_ms`` in the stats), so a
    saturated run is visible instead of silently closed-loop."""

    def __init__(self, target, max_outstanding: int = 128):
        self.target = target
        self.max_outstanding = max_outstanding
        self._sem = threading.Semaphore(max_outstanding)

    def run(
        self,
        events: Sequence[TraceEvent],
        *,
        speed: float = 1.0,
        faults: Sequence[FaultPlan] = (),
        recovery_probe_s: float = 10.0,
        settle_s: float = 0.0,
    ) -> LoadReport:
        """Issue every event at ``event.ts / speed`` on the run clock,
        arming/clearing the ``faults`` timeline as it passes; after
        the last response (or loss) resolves, probe readiness
        recovery for up to ``recovery_probe_s``. ``settle_s`` extends
        the run past the last arrival (open-loop tail: late responses
        still count)."""
        if speed <= 0:
            raise ValueError(f"speed must be > 0, got {speed}")
        report = LoadReport()
        plans = sorted(faults, key=lambda p: p.at_s)
        threads: List[threading.Thread] = []
        t0 = time.perf_counter()
        plan_i = 0
        for i, ev in enumerate(events):
            sched = ev.ts / speed
            # chaos due before the next issue: sleep to each plan's OWN
            # instant first — arming at the head of a long inter-arrival
            # gap would fire (and possibly for_s-expire) the fault long
            # before the requested at_s
            while plan_i < len(plans) and plans[plan_i].at_s <= sched:
                wait = plans[plan_i].at_s - (time.perf_counter() - t0)
                if wait > 0:
                    time.sleep(wait)
                self._arm(plans[plan_i], t0, report)
                plan_i += 1
            wait = sched - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            self._sem.acquire()
            t_send = time.perf_counter() - t0
            th = threading.Thread(
                target=self._issue,
                args=(i, ev, t_send, sched, report),
                name=f"keystone-loadgen-{i}",
                daemon=True,
            )
            report.issued += 1
            th.start()
            threads.append(th)
        # chaos scheduled past the last arrival still runs
        for plan in plans[plan_i:]:
            wait = plan.at_s - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            self._arm(plan, t0, report)
        if settle_s > 0:
            time.sleep(settle_s)
        for th in threads:
            th.join(timeout=SERVER_RESULT_BOUND_S + LOST_SLACK_S + 60.0)
        # clear any fault the timeline left armed, stamping t_clear
        self._clear_all(t0, report)
        report.duration_s = time.perf_counter() - t0
        self._probe_recovery(t0, report, recovery_probe_s)
        return report

    # -- internals ---------------------------------------------------------

    def _issue(
        self,
        index: int,
        ev: TraceEvent,
        t_send: float,
        t_sched: float,
        report: LoadReport,
    ) -> None:
        try:
            rec = self.target.send(ev)
        except Exception as e:  # a target bug must not strand the run
            logger.exception("loadgen target.send failed")
            rec = RequestRecord(
                0, 0.0, 0.0, "error",
                reason=f"target raised {type(e).__name__}: {e}",
                untyped=True,
            )
        finally:
            self._sem.release()
        rec.index = index
        rec.t_send = t_send
        rec.t_sched = t_sched
        report.add(rec)

    def _arm(
        self, plan: FaultPlan, t0: float, report: LoadReport
    ) -> None:
        spec = dict(plan.spec)
        if plan.for_s is not None:
            # the server self-disarms even if this driver dies
            spec.setdefault("for_s", plan.for_s)
        now = time.perf_counter() - t0
        logger.info("chaos: arming %s at t=%.2fs", spec, now)
        try:
            self.target.arm_fault(spec)
        except Exception:
            logger.exception("chaos arm failed for %s", spec)
            return
        # the clear time may come from EITHER the plan or a for_s
        # inside the spec clause itself; missing both means "armed
        # until the run ends" and _clear_all stamps it. Getting this
        # wrong shifts the recovery window the invariants measure.
        duration = (
            plan.for_s if plan.for_s is not None else spec.get("for_s")
        )
        report.fault_windows.append(
            FaultWindow(
                point=spec["point"], t_arm=now,
                t_clear=(now + duration) if duration else None,
                spec=spec,
            )
        )

    def _clear_all(self, t0: float, report: LoadReport) -> None:
        now = time.perf_counter() - t0
        for w in report.fault_windows:
            if w.t_clear is None or w.t_clear > now:
                try:
                    self.target.disarm_fault(w.point)
                except Exception:
                    logger.exception("chaos disarm failed for %s", w.point)
                w.t_clear = now

    def _probe_recovery(
        self, t0: float, report: LoadReport, bound_s: float
    ) -> None:
        if not report.fault_windows or bound_s <= 0:
            return
        report.ready_probed = True
        cleared = max(w.t_clear for w in report.fault_windows)
        # probe at least once even when the run tail already consumed
        # the bound (recovery may have happened while we drained)
        deadline = max(
            t0 + cleared + bound_s, time.perf_counter() + 0.5
        )
        while True:
            if self.target.ready():
                # an upper bound: ready may have flipped back earlier,
                # we only observe it at probe time
                report.ready_recovery_s = max(
                    0.0, (time.perf_counter() - t0) - cleared
                )
                return
            if time.perf_counter() >= deadline:
                break
            time.sleep(0.1)
        report.ready_recovery_s = None  # never recovered in bound


__all__ = [
    "FaultPlan",
    "FaultWindow",
    "FeedbackSender",
    "HttpTarget",
    "InprocTarget",
    "LoadGenerator",
    "LoadReport",
    "RequestRecord",
    "TYPED_SHED_REASONS",
]
