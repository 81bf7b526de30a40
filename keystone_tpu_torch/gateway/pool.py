"""EnginePool: shared-nothing replica lanes behind one submit()
(counterpart of ``keystone_tpu/gateway/pool.py``).

N lanes, each a private ``MicroBatcher`` + ``CompiledPipeline`` pair —
no cross-lane state. With ``pipeline_depth > 0`` each lane's batcher
runs as a STAGED PIPELINE (serving/pipeline.py: host-prep / upload /
compute / deliver threads behind bounded handoff queues), overlapping
one window's host work with the previous window's device compute;
``host_featurize`` plugs an items-mode front-end into every lane's prep
stage. Device-side featurization rides the ``engine_factory`` instead:
the Gateway's factory builds each lane engine with
``CompiledPipeline(featurize=...)``, so every generation (initial
build, rebucket replacements, warm-pool swaps) carries the fused
featurize∘model CUDA graphs and lanes stage raw bytes. Each lane's
engine captures its own bucket graphs. The pool adds the three things a
replica set needs beyond execution:

- **least-loaded routing** — ``submit()`` hands each request to the
  healthy lane with the fewest unresolved requests, so one slow window
  doesn't queue the world behind it;
- **per-lane health** — a lane is charged a health failure only when a
  request it failed SUCCEEDS on another lane (proof the fault was
  lane-specific, not the request's own); ``UNHEALTHY_AFTER`` such
  failures bench it until a cool-down elapses (half-open probe) or
  every other lane is also out. Errors that reproduce on the retry
  lane are request-caused and charge nobody — malformed client traffic
  can never bench the pool and starve well-formed requests;
- **retry-to-another-lane** — a failed request is retried once on a
  different lane before its error propagates, so a single lane's
  transient failure (poisoned window, device hiccup) is invisible to
  callers. Deterministically-bad requests still fail: the retry lane
  reproduces the error and it propagates.

``status()`` is the zoo's ``/planz`` snapshot of a pool. The online
lifecycle plugs in through ``set_mirror`` (a shadow mirror sees a copy
of every submit, off the response path) and ``set_canary`` (a canary
router serves the deterministic fraction ``canary_takes`` of submits
from the candidate, falling back to the lanes on any candidate failure);
``pick`` is the routing decision, public.

``swap()`` is the live-engine-replacement primitive the lifecycle loop
drives: build + warm replacements for every lane FIRST (any failure
aborts the swap with the old engines still serving), then atomically
re-point each lane's batcher (``MicroBatcher.swap_engine``) — in-flight
windows finish on the old engines, queued and future requests dispatch
through the new ones, and nothing is dropped.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.serving.batching import MicroBatcher
from keystone_tpu_torch.serving.engine import CompiledPipeline

logger = logging.getLogger(__name__)

# consecutive failures that bench a lane, and how long it sits out
# before the router half-opens it again
UNHEALTHY_AFTER = 3
RECOVERY_AFTER_S = 5.0

# EngineFactory(lane_name) -> a fresh engine for that lane
EngineFactory = Callable[[str], CompiledPipeline]


def canary_takes(seq: int, fraction: float) -> bool:
    """The DETERMINISTIC canary decision for request number ``seq``
    (0-based): True exactly when the integer part of ``seq·fraction``
    advances, i.e. of any n consecutive requests ``floor(n·fraction)``
    (±1) are canaried — evenly spread, no RNG, reproducible. The
    lifecycle's ``CanaryRouter`` drives ``submit()`` with this; it is
    a module function so the policy tests can pin its arithmetic
    without a pool."""
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    return int((seq + 1) * fraction) > int(seq * fraction)


class Lane:
    """One replica: a private engine behind a private micro-batcher,
    plus the load/health accounting the router reads."""

    def __init__(
        self,
        engine: CompiledPipeline,
        index: int,
        max_delay_ms: float = 5.0,
        capacity: Optional[int] = None,
        pipeline_depth: int = 0,
        host_featurize=None,
    ):
        self.index = index
        self.batcher = MicroBatcher(
            engine,
            max_delay_ms=max_delay_ms,
            pipeline_depth=pipeline_depth,
            host_featurize=host_featurize,
        )
        self._capacity_pinned = int(capacity) if capacity else None
        self._lock = threading.Lock()
        self._inflight = 0  # guarded-by: _lock
        self._consecutive_failures = 0  # guarded-by: _lock
        self._last_failure_t = 0.0  # guarded-by: _lock

    @property
    def capacity(self) -> int:
        """How many unresolved requests this lane will hold before the
        admission router stops feeding it: two full windows keeps the
        batcher's next window filling while one executes — plus one
        window per pipeline stage-depth when the lane is a staged
        pipeline, so the prep/upload/compute stages all have a window
        to chew on. Unless pinned it tracks the CURRENT engine's window
        size, so a rebucket to larger buckets also widens the lane (a
        frozen bound would cap throughput at the old bucket's scale)."""
        if self._capacity_pinned is not None:
            return self._capacity_pinned
        return (
            (2 + self.batcher.pipeline_depth) * self.batcher.max_batch
        )

    @property
    def engine(self) -> CompiledPipeline:
        return self.batcher.engine

    @property
    def load(self) -> int:
        with self._lock:
            return self._inflight

    @property
    def free(self) -> int:
        with self._lock:
            return max(0, self.capacity - self._inflight)

    @property
    def healthy(self) -> bool:
        with self._lock:
            if self._consecutive_failures < UNHEALTHY_AFTER:
                return True
            # half-open: after the cool-down the lane gets probe traffic
            # again; one success fully restores it
            return (
                time.perf_counter() - self._last_failure_t
                > RECOVERY_AFTER_S
            )

    def submit(
        self, example: Any, parent_span_id: Optional[int] = None
    ) -> Future:
        with self._lock:
            self._inflight += 1
        # chaos point: an armed gateway.lane.kill (typically matched to
        # one lane index) fails requests routed here mid-flight; the
        # pool's retry-to-another-lane + success-corroborated health
        # charging must absorb it exactly like a real lane fault. The
        # raise sits AFTER the inflight increment so the router's
        # release() stays balanced. Unarmed: the armed() gate is one
        # attribute read, and the ctx dict is never even built.
        if faults.armed() and faults.fire(
            "gateway.lane.kill", {"lane": self.index}
        ) is not None:
            raise faults.FaultInjected("gateway.lane.kill", lane=self.index)
        return self.batcher.submit(example, parent_span_id=parent_span_id)

    def release(self) -> None:
        """One request left this lane (resolved either way) — load
        accounting only; health attribution is separate."""
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    def mark_ok(self) -> None:
        with self._lock:
            self._consecutive_failures = 0

    def mark_failed(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            self._last_failure_t = time.perf_counter()

    def close(self, timeout: Optional[float] = 10.0) -> None:
        self.batcher.close(timeout=timeout)


class EnginePool:
    """N shared-nothing lanes with least-loaded routing, health
    tracking, retry-on-lane-failure, and atomic engine swap."""

    def __init__(
        self,
        engine_factory: EngineFactory,
        n_lanes: int = 2,
        *,
        name: str = "gateway",
        max_delay_ms: float = 5.0,
        lane_capacity: Optional[int] = None,
        max_retries: int = 1,
        metrics=None,  # GatewayMetrics; duck-typed so tests can stub
        pipeline_depth: int = 0,
        host_featurize=None,
    ):
        if n_lanes < 1:
            raise ValueError(f"need at least one lane, got {n_lanes}")
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_retries = max_retries
        self.name = name
        self.metrics = metrics
        self._factory = engine_factory  # guarded-by: _lock
        self._max_delay_ms = max_delay_ms
        self._lane_capacity = lane_capacity
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        # lifecycle hooks (duck-typed; see lifecycle/routes.py): a
        # mirror sees a COPY of every submit off the response path, a
        # canary serves a deterministic fraction ON it. Plain attribute
        # writes — submit() reads each once, so the disarmed cost is
        # two attribute reads and None-checks per request
        self._mirror = None
        self._canary = None
        self._free_listeners: List[Callable[[], None]] = []
        self.lanes: List[Lane] = [
            Lane(
                engine_factory(self.lane_name(i)),
                i,
                max_delay_ms=max_delay_ms,
                capacity=lane_capacity,
                pipeline_depth=pipeline_depth,
                host_featurize=host_featurize,
            )
            for i in range(n_lanes)
        ]

    def status(self) -> dict:
        """One inspection snapshot per pool — what ``/planz`` reports
        as a model's ACTUAL placement (lane count, the lanes' current
        bucket list, health/load) next to the optimizer's plan."""
        return {
            "lanes": len(self.lanes),
            "healthy_lanes": self.healthy_lanes(),
            "buckets": list(self.lanes[0].engine.buckets),
            "free_capacity": self.free_capacity(),
            "total_load": self.total_load(),
        }

    def lane_name(self, index: int) -> str:
        return f"{self.name}-lane{index}"

    # -- capacity signals (the admission router's pacing inputs) -----------

    def add_free_listener(self, fn: Callable[[], None]) -> None:
        """``fn`` fires (from a completion callback thread) whenever a
        lane slot frees — the admission router waits on this instead of
        polling."""
        self._free_listeners.append(fn)

    def _notify_free(self) -> None:
        for fn in self._free_listeners:
            try:
                fn()
            except Exception:
                logger.exception("pool free-listener failed")

    def free_capacity(self) -> int:
        return sum(l.free for l in self.lanes if l.healthy)

    def total_load(self) -> int:
        return sum(l.load for l in self.lanes)

    def healthy_lanes(self) -> int:
        return sum(1 for l in self.lanes if l.healthy)

    # -- routing -----------------------------------------------------------

    def set_mirror(self, mirror) -> None:
        """Install (or clear, with None) the shadow mirror — every
        subsequent ``submit()`` also hands the example + primary
        future to ``mirror.observe`` off the response path."""
        self._mirror = mirror

    def set_canary(self, canary) -> None:
        """Install (or clear, with None) the canary router — it takes
        a deterministic fraction of subsequent ``submit()``s onto the
        candidate engine, falling back to the lanes on failure."""
        self._canary = canary

    def pick(self, exclude: Sequence[Lane] = ()) -> Optional[Lane]:
        """The routing decision ``submit()`` uses, public: the
        least-loaded healthy lane (unhealthy lanes only when nothing
        else is left). The canary fraction rides ON TOP of this — a
        canaried request bypasses the lanes entirely, everything else
        lands here."""
        return self._pick(exclude)

    def _pick(self, exclude: Sequence[Lane]) -> Optional[Lane]:
        candidates = [
            l for l in self.lanes if l.healthy and l not in exclude
        ]
        if not candidates:
            # availability over purity: an unhealthy lane beats shedding
            # when it is the only lane left (and gives it probe traffic)
            candidates = [l for l in self.lanes if l not in exclude]
        if not candidates:
            return None
        return min(candidates, key=lambda l: l.load)

    def submit(
        self, example: Any, parent_span_id: Optional[int] = None
    ) -> Future:
        """Route one example to the least-loaded healthy lane. The
        returned future resolves with the example's pipeline output; on
        a lane failure the request is retried once on a different lane
        before the error propagates."""
        if self._closed:
            raise RuntimeError("EnginePool is closed")
        out: Future = Future()
        canary = self._canary
        if canary is not None and canary.takes():
            # a deterministic fraction serves from the candidate
            # engine; the router falls back to the incumbent lanes on
            # any candidate failure, so callers never see one
            canary.route(
                example, parent_span_id, out,
                lambda: self._submit_once(
                    example, parent_span_id, out, tried=[]
                ),
            )
        else:
            self._submit_once(example, parent_span_id, out, tried=[])
        mirror = self._mirror
        if mirror is not None:
            # off the response path: the mirror copies the example to
            # the candidate and diffs outputs in completion callbacks;
            # it must never raise (and ShadowMirror.observe doesn't),
            # and `out` is already on its way either way
            mirror.observe(example, out)
        return out

    def _submit_once(
        self,
        example: Any,
        parent_span_id: Optional[int],
        out: Future,
        tried: List[Lane],
    ) -> None:
        lane = self._pick(exclude=tried)
        if lane is None:
            out.set_exception(
                RuntimeError(f"no lane available (tried {len(tried)})")
            )
            return
        tried.append(lane)
        # which lane served this request (the LAST one tried wins on a
        # retry) — the admission layer copies it onto the caller-facing
        # future for the request log and flight-recorder attrs
        out.lane_index = lane.index
        try:
            fut = lane.submit(example, parent_span_id=parent_span_id)
        except Exception as e:
            # a submit-time raise (closed batcher mid-drain, or an
            # example whose spec can't even be computed) gets the same
            # treatment as a dispatch failure: retry elsewhere, and NO
            # unilateral health charge — only the success-corroboration
            # path in done() may bench a lane, else malformed requests
            # could bench the pool
            lane.release()
            retriable = [l for l in self.lanes if l not in tried]
            if (
                retriable
                and len(tried) <= self.max_retries
                and not self._closed
            ):
                if self.metrics is not None:
                    self.metrics.record_retry()
                self._submit_once(example, parent_span_id, out, tried)
            else:
                try:
                    out.set_exception(e)
                except Exception:
                    pass  # caller cancelled concurrently
            return

        def done(f: Future) -> None:
            err = f.exception()
            lane.release()
            self._notify_free()
            if err is None:
                # health attribution happens only on success: THIS lane
                # is fine, and any lane that failed this same request
                # earlier failed where another succeeded — a
                # lane-specific fault, safe to count against it
                lane.mark_ok()
                for failed in tried[:-1]:
                    failed.mark_failed()
                if not out.cancelled():
                    out.set_result(f.result())
                return
            # retry on a DIFFERENT lane at most max_retries times
            # (default once): transient lane failures heal invisibly;
            # deterministic request errors reproduce on the retry lane
            # and propagate instead of touring every lane of a big pool
            retriable = [
                l for l in self.lanes if l not in tried
            ]
            if (
                retriable
                and len(tried) <= self.max_retries
                and not self._closed
            ):
                if self.metrics is not None:
                    self.metrics.record_retry()
                logger.warning(
                    "lane %d failed a request (%s); retrying on "
                    "another lane", lane.index, err,
                )
                self._submit_once(example, parent_span_id, out, tried)
            else:
                # terminal failure: the error reproduced on every lane
                # we tried (or no other lane exists) — that signature is
                # a request-caused error, so NO lane's health is dinged:
                # a trickle of malformed requests must never bench the
                # pool and starve well-formed traffic
                try:
                    out.set_exception(err)
                except Exception:
                    pass  # caller cancelled while we were failing

        fut.add_done_callback(done)

    # -- lifecycle primitives ----------------------------------------------

    def swap(
        self,
        engine_factory: Optional[EngineFactory] = None,
        warmup_example: Any = None,
        engines: Optional[Sequence[CompiledPipeline]] = None,
    ) -> List[CompiledPipeline]:
        """Replace every lane's engine atomically-per-lane: build (and
        optionally warm) ALL replacements first — a failure there aborts
        the swap with the old engines untouched — then re-point each
        lane's batcher. Returns the displaced engines (callers normally
        drop them; in-flight windows finish on them regardless).

        ``engines``: PREBUILT (and already-warmed) replacements, one
        per lane in lane order — the Gateway warm-pool path builds the
        next generation outside this lock (on a background builder
        thread), so the work under the lock here is just the atomic
        re-point.

        Engines are rebuilt under their lane's original name, so the
        ServingMetrics label-transfer rule keeps one Prometheus series
        per lane across any number of swaps."""
        factory = engine_factory or self._factory
        if engines is not None and len(engines) != len(self.lanes):
            raise ValueError(
                f"need one prebuilt engine per lane "
                f"({len(self.lanes)}), got {len(engines)}"
            )
        if self._closed:
            raise RuntimeError("EnginePool is closed")
        if engines is not None:
            replacements = list(engines)
        else:
            # build + warm OUTSIDE the pool lock: the generation build
            # is seconds of graph captures, and holding the lock for it
            # would stall close() and every other lifecycle call behind
            # one swap. The lock
            # below covers only the atomic re-point — the same
            # work-split the Gateway warm pool uses. Swap-vs-swap
            # serialization is the caller's job (the Gateway holds its
            # _swap_lock); racing bare-pool swaps would build two
            # generations and rotate them in arrival order.
            replacements = self.build_replacements(
                factory, warmup_example=warmup_example
            )
        with self._lock:
            if self._closed:
                raise RuntimeError("EnginePool is closed")
            old = [
                lane.batcher.swap_engine(eng)
                for lane, eng in zip(self.lanes, replacements)
            ]
            self._factory = factory
        if self.metrics is not None:
            self.metrics.record_swap()
        logger.info(
            "pool %s swapped %d lane engine(s); buckets now %s",
            self.name, len(old), replacements[0].buckets,
        )
        return old

    def build_replacements(
        self,
        engine_factory: Optional[EngineFactory] = None,
        warmup_example: Any = None,
    ) -> List[CompiledPipeline]:
        """Build (and optionally warm) one replacement engine per lane
        under the lanes' names — the ONE generation-build loop, shared
        by ``swap()``'s build-inline path and the Gateway warm pool
        (which runs it outside this pool's lock and hands the result
        back via ``swap(engines=...)``)."""
        factory = engine_factory or self._factory
        replacements = []
        for lane in self.lanes:
            eng = factory(self.lane_name(lane.index))
            if warmup_example is not None:
                eng.warmup(example=warmup_example)
            replacements.append(eng)
        return replacements

    def warmup(self, example: Any) -> None:
        for lane in self.lanes:
            lane.engine.warmup(example=example)

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Stop accepting, then flush every lane's batcher (pending
        windows dispatch and their futures resolve)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for lane in self.lanes:
            lane.close(timeout=timeout)

    def __enter__(self) -> "EnginePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
