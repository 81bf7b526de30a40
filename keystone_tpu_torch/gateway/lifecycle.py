"""Gateway: engine lifecycle, not just engine execution (counterpart of
``keystone_tpu/gateway/lifecycle.py``).

``Gateway`` composes the request plane — ``AdmissionController`` in
front of an ``EnginePool`` whose lanes run as staged pipelines by
default (``pipeline_depth=2``: host-prep, H2D upload, and device
compute of consecutive windows overlap; serving/pipeline.py) — and
owns everything about the engines' *lives*:

- **build + warm** — lanes come up with every bucket's CUDA graph
  captured before the gateway reports ready (``warmup_example``), so
  captures never land in the traffic latency distribution;
- **live re-bucketing** — ``rebucket()`` closes the autoscale
  loop: read the lanes' observed request-size histogram
  (``ServingMetrics.request_sizes``), ask
  ``serving/autoscale.suggest_buckets`` for the padding-minimal bucket
  set, and when the proposal differs, build + warm replacement engines
  in the background and atomically swap them behind the micro-batchers
  (``EnginePool.swap``) — zero dropped requests, responses straddling
  the swap numerically identical. A ``maintenance_interval_s`` runs
  this periodically off a daemon thread;
- **graceful shutdown** — ``close()`` (or SIGTERM via
  ``install_signal_handlers``) flips readiness (``/readyz`` goes 503 so
  load balancers stop sending), stops admitting (typed
  ``Overloaded('closed')``), drains the admission queue, and flushes
  every lane's micro-batcher so already-admitted requests resolve;
- **SLO enforcement + forensics** (``slo_latency_s=``) — declares a
  latency SLO (and an availability SLO) over the gateway's own metric
  series, samples multi-window burn rates (``observability/slo.py``),
  and runs a *watchdog*: a sustained fast-window burn tightens
  admission (``AdmissionController.set_pressure`` — shed early, with
  reason ``slo_pressure``, before the queue saturates) and relaxes it
  once the burn subsides. The same threshold drives the tail-sampling
  flight recorder: requests that breach it (or error) get their full
  span tree pinned for ``/debugz``.

Readiness vs liveness: ``ready`` is a routing signal (admitting and
warmed) — the admin endpoint's ``/healthz`` stays the liveness probe
(process up), and a draining gateway is alive but not ready. The burn
state is surfaced in ``/readyz``'s body (still 200 — burning is a
"stop sending so fast", not a "stop sending").

- **the online lifecycle's hooks** — ``build_model_batcher`` builds a
  candidate's own engine (one CUDA graph per bucket, captured at once;
  on the candidate's own AOT store when given one) and micro-batcher
  over this gateway's serving config, and ``swap_model`` rotates every
  lane onto engines built from another fitted pipeline (promotion, and
  rollback to the incumbent), optionally on another store.

Every swap (``rebucket``, ``swap_engines``, ``swap_model``) retires the
engines it displaced (``CompiledPipeline.retire``): once the windows
the lanes took for them have computed, the last of them releases their
graphs and private memory pools, without ``empty_cache``, so the memory
a generation holds does not pile up over the versions a lifecycle walks
through.

``param_sharding`` and ``aot_store`` go to every engine generation the
factory builds (``serving/sharding.py``, ``serving/aot.py``): on one
card a sharded model's params are placed whole by each lane's engine,
and the store gives each engine its kernel libraries and bucket
entries. ``engine_factory=`` is the zoo's seam (``zoo/host.py`` builds
shared-prefix engines through it); a gateway on it cannot build engines
from a fitted pipeline, so its lifecycle hooks raise, as in JAX.
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional, Sequence

import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.gateway.admission import AdmissionController, Overloaded
from keystone_tpu_torch.gateway.metrics import GatewayMetrics
from keystone_tpu_torch.gateway.pool import EnginePool
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability.flight import FlightRecorder
from keystone_tpu_torch.observability.slo import Slo, SloMonitor
from keystone_tpu_torch.serving.autoscale import (
    predicted_efficiency,
    suggest_buckets,
)
from keystone_tpu_torch.serving.batching import MicroBatcher
from keystone_tpu_torch.serving.engine import DEFAULT_BUCKETS

logger = logging.getLogger(__name__)

# observations required before an UNFORCED rebucket may act: a proposal
# from a handful of requests is noise, not traffic
MIN_REBUCKET_OBSERVATIONS = 64

# SLO watchdog defaults: tighten admission after the fast-window burn
# holds >= SHED_BURN for SUSTAIN consecutive samples; relax once it
# falls back under 1.0 (budget no longer being consumed too fast)
SLO_SHED_BURN = 4.0

SLO_SUSTAIN_SAMPLES = 2
SLO_PRESSURE = 0.75

# swap_model's "keep the store as it is" default (the JAX signature)
_UNCHANGED = object()


def _fmt_eff(eff) -> str:
    return f"{eff:.3f}" if eff is not None else "n/a"


class Gateway:
    """The serving front door over one fitted pipeline.

    Parameters
    ----------
    fitted:            the ``FittedPipeline`` to serve (each lane gets
                       its own ``CompiledPipeline`` over it).
    buckets:           initial row buckets per lane engine.
    n_lanes:           replica lanes (shared-nothing engine copies).
    warmup_example:    one example (no batch axis) used to capture
                       every bucket's graph at construction and after
                       each swap; without it lanes capture at each
                       bucket's first dispatch and the first requests
                       eat the captures.
    pipeline_depth:    stage-queue depth of each lane's STAGED pipeline
                       (serving/pipeline.py): window k+1's host-prep
                       and H2D upload overlap window k's device
                       compute, results bit-identical to serial. The
                       default (2) double-buffers every handoff; 0
                       reverts the lanes to strictly serial dispatch.
    host_featurize:    optional items-mode prep hook — a callable
                       turning one coalesced window of RAW examples
                       (arrays, strings, records...) into the batched
                       array tree the lane engines stage. Runs on the
                       host-prep stage (or inline when serial), so
                       tokenizer/featurizer front-ends burn host cores
                       while the device computes the previous window.
    device_featurize:  optional fitted featurize pipeline fused into
                       every lane engine's bucket programs IN FRONT of
                       ``fitted`` (``CompiledPipeline(featurize=...)``):
                       clients submit RAW examples (e.g. uint8 images
                       — ~4× fewer H2D bytes than f32 features), the
                       host-prep stage only stacks/pads them into the
                       pooled staging buffers, and cast + featurize +
                       predict ride one CUDA graph replay. Requires
                       an array-mode featurize chain that captures
                       (no host syncs on the card); keep ``host_featurize`` for native/
                       items-mode featurizers — the two COMPOSE (host
                       hook decodes raw bytes into uint8 arrays, the
                       device stage featurizes them). Swaps/rebuckets
                       rebuild lane engines with the same fused stage;
                       ``warmup_example`` must be a RAW example in
                       this mode.
    param_sharding:    shard the MODEL over the process mesh's model
                       axis (serving/sharding.py): ``True`` resolves
                       the default rule set, a rules sequence or a
                       ``{name: spec}`` dict partitions explicitly.
                       Every engine generation carries it, placed over
                       the mesh current at build time (``serve-gateway
                       --shard-model`` pins it with ``set_mesh``); on
                       one card each lane's engine places the params
                       whole, as its own copy.
    aot_store:         the store engine builds consult: ``"auto"``
                       (process-configured), ``None``/``False`` (off),
                       or an ``AotStore`` (the zoo passes per-model
                       namespaced stores).
    engine_factory:    optional override, ``callable(buckets) ->
                       (lane_name -> engine)`` — replaces the
                       ``fitted.compiled()`` factory for every engine
                       generation (the zoo builds shared-prefix
                       multi-head engines through this seam).
    device:            where every lane engine stages and runs (the
                       fitted pipeline's parameters must live there);
                       ``None`` means ``cuda``.
    max_pending:       admission queue bound.
    default_deadline_ms: deadline applied to requests that don't carry
                       their own.
    maintenance_interval_s: period of the background rebucket loop
                       (None/0 = off; ``rebucket()`` stays callable).
    rebucket_k:        bucket-set size the autoscaler proposes
                       (default: len(buckets)).
    slo_latency_s:     declare + enforce a latency SLO at this
                       threshold (None = whole SLO/forensics plane off,
                       zero overhead): burn-rate monitoring, the
                       admission-tightening watchdog, and tail-sampled
                       flight recording all hang off it.
    slo_target:        fraction of requests that must make the latency
                       threshold (error budget = 1 - target).
    slo_availability_target: fraction of requests that must not error.
    slo_fast_window_s / slo_slow_window_s / slo_sample_interval_s:
                       burn-rate evaluation windows and sampling period
                       (tests shrink these to milliseconds).
    slo_shed_burn:     fast-window burn rate that (sustained for
                       ``slo_sustain_samples``) trips admission
                       tightening.
    slo_pressure:      how hard the watchdog tightens (queue bound
                       shrinks to ``max_pending * (1 - pressure)``).
    flight_capacity:   forensic ring size (records, not spans).
    """

    def __init__(
        self,
        fitted,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        n_lanes: int = 2,
        max_delay_ms: float = 5.0,
        lane_capacity: Optional[int] = None,
        warmup_example: Any = None,
        pipeline_depth: int = 2,
        host_featurize=None,
        device_featurize=None,
        param_sharding=None,
        aot_store="auto",
        device=None,
        engine_factory=None,
        max_pending: int = 1024,
        default_deadline_ms: Optional[float] = None,
        maintenance_interval_s: Optional[float] = None,
        rebucket_k: Optional[int] = None,
        name: str = "gateway",
        registry=None,
        slo_latency_s: Optional[float] = None,
        slo_target: float = 0.99,
        slo_availability_target: float = 0.999,
        slo_fast_window_s: float = 60.0,
        slo_slow_window_s: float = 1800.0,
        slo_sample_interval_s: float = 5.0,
        slo_shed_burn: float = SLO_SHED_BURN,
        slo_sustain_samples: int = SLO_SUSTAIN_SAMPLES,
        slo_pressure: float = SLO_PRESSURE,
        flight_capacity: int = 64,
    ):
        self.name = name
        self.fitted = fitted
        self._device = device
        # normalized exactly like CompiledPipeline normalizes its own
        # bucket set, so buckets[-1] is genuinely the max bucket the
        # rebucket loop must force and proposal comparisons are stable
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._warmup_example = warmup_example
        # fused into every engine generation the factory builds —
        # initial lanes, rebucket replacements, and warm-pool swaps all
        # carry the same device-side featurize stage
        self._device_featurize = device_featurize
        self._param_sharding = param_sharding
        self._aot_store = aot_store
        self._engine_factory = engine_factory
        # the lanes' batching config, which a candidate's batcher copies
        self._max_delay_ms = max_delay_ms
        self._pipeline_depth = pipeline_depth
        self._host_featurize = host_featurize
        self._rebucket_k = rebucket_k or len(self._buckets)
        self.metrics = GatewayMetrics(registry=registry, gateway=name)
        # seconds of this gateway's start: the lanes' engines, and their
        # warmup (captures, the AOT store)
        self.startup_s: Dict[str, float] = {}
        t0 = time.perf_counter()
        self.pool = EnginePool(
            self._factory_for(self._buckets),
            n_lanes,
            name=name,
            max_delay_ms=max_delay_ms,
            lane_capacity=lane_capacity,
            metrics=self.metrics,
            pipeline_depth=pipeline_depth,
            host_featurize=host_featurize,
        )
        self.startup_s["lanes"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if warmup_example is not None:
            self.pool.warmup(warmup_example)
        self.startup_s["warmup"] = time.perf_counter() - t0
        # where the first lane took each kernel library from (the
        # later lanes find them built)
        libraries = {
            k: v for lane in reversed(self.pool.lanes)
            for k, v in getattr(lane.engine, "aot_libraries", {}).items()
        }
        if libraries:
            self.startup_s["libraries"] = libraries
        # -- SLO + forensics plane (off unless a latency SLO declared) -
        self.flight: Optional[FlightRecorder] = None
        self.slo_monitor: Optional[SloMonitor] = None
        self._latency_slo: Optional[Slo] = None
        self._slo_shed_burn = float(slo_shed_burn)
        self._slo_sustain_samples = int(slo_sustain_samples)
        self._slo_pressure = float(slo_pressure)
        self._slo_hot_samples = 0
        if slo_latency_s is not None:
            self.flight = FlightRecorder(
                flight_capacity,
                latency_threshold_s=slo_latency_s,
                registry=registry,
            )
            self.slo_monitor = SloMonitor(
                fast_window_s=slo_fast_window_s,
                slow_window_s=slo_slow_window_s,
                registry=registry,
            )
            self._latency_slo = self.slo_monitor.add(
                Slo.latency(
                    f"{name}:latency",
                    self.metrics.request_latency,
                    threshold_s=slo_latency_s,
                    target=slo_target,
                    labels=(name,),
                )
            )
            self.slo_monitor.add(
                Slo.availability(
                    f"{name}:availability",
                    self.metrics.requests_total,
                    target=slo_availability_target,
                    base_labels=(name,),
                )
            )
            self.slo_monitor.add_listener(self._slo_watchdog)
            self.slo_monitor.start(slo_sample_interval_s)
        self.admission = AdmissionController(
            self.pool,
            max_pending=max_pending,
            default_deadline_ms=default_deadline_ms,
            metrics=self.metrics,
            name=name,
            flight=self.flight,
            forensic_threshold_s=slo_latency_s,
        )
        # the last re-bucket's goodput audit (observed-before vs
        # model-predicted-after padding efficiency); None until a swap
        self.last_rebucket_audit: Optional[Dict] = None
        self._closed = False
        self._close_lock = threading.Lock()
        self._drained = threading.Event()
        # one swap at a time: the maintenance loop and POST /swap must
        # not interleave build/swap/assign sequences
        self._swap_lock = threading.RLock()
        self._maint_stop = threading.Event()
        # chaos point: arming gateway.swap.force (via code, env, or
        # POST /chaosz; match gateway=<name> to target one of several)
        # forces a live rebucket on a background thread — the "swap
        # under peak load" experiment, driving the same path as
        # POST /swap
        self._chaos_unregister = faults.get_injector().register_trigger(
            "gateway.swap.force",
            self._chaos_forced_swap,
            ctx={"gateway": name},
        )
        self._maint: Optional[threading.Thread] = None
        if maintenance_interval_s:
            self._maint = threading.Thread(
                target=self._maintenance_loop,
                args=(float(maintenance_interval_s),),
                name=f"keystone-{name}-lifecycle",
                daemon=True,
            )
            self._maint.start()

    def _factory_for(self, buckets):
        if self._engine_factory is not None:
            return self._engine_factory(buckets)

        def factory(lane_name: str):
            return self.fitted.compiled(
                buckets=buckets, name=lane_name,
                featurize=self._device_featurize,
                device=self._device,
                param_sharding=self._param_sharding,
                aot_store=self._aot_store,
            )

        return factory

    # -- serving -----------------------------------------------------------

    def predict(
        self,
        example: Any,
        deadline_ms: Optional[float] = None,
        trace_id: Optional[str] = None,
    ) -> Future:
        """Admit one example; resolves to its pipeline output. Raises
        ``Overloaded`` immediately when shed. ``trace_id`` adopts a
        remote trace identity (see ``AdmissionController.submit``)."""
        return self.admission.submit(
            example, deadline_ms=deadline_ms, trace_id=trace_id
        )

    @property
    def ready(self) -> bool:
        """Routing signal: admitting traffic (drain flips this false
        before any request is refused)."""
        return not self._closed and self.admission.accepting

    @property
    def buckets(self) -> tuple:
        return self._buckets

    @property
    def device(self) -> torch.device:
        """Where the lane engines stage and run."""
        return resolve_device(self._device)

    # -- SLO watchdog ------------------------------------------------------

    def _slo_watchdog(self, monitor: SloMonitor) -> None:
        """Runs after every burn-rate sample: a sustained fast-window
        burn tightens admission (shed early, before the queue
        saturates); the pressure releases once the burn drops back
        under 1.0 — budget consumption at a sustainable rate again."""
        burns = monitor.burn_rates(self._latency_slo.name)
        fast = burns.get("fast")
        if fast is None:
            return
        if fast >= self._slo_shed_burn:
            self._slo_hot_samples += 1
            if (
                self._slo_hot_samples >= self._slo_sustain_samples
                and self.admission.pressure == 0.0
            ):
                self.admission.set_pressure(self._slo_pressure)
                self.metrics.set_slo_pressure(self._slo_pressure)
                logger.warning(
                    "gateway %s: fast-window SLO burn %.1f sustained "
                    "%d samples; tightening admission (pressure %.2f)",
                    self.name, fast, self._slo_hot_samples,
                    self._slo_pressure,
                )
        else:
            # "sustained" means CONSECUTIVE over-threshold samples: any
            # cooler sample resets the streak, so isolated spikes hours
            # apart can never accumulate into a tightening
            self._slo_hot_samples = 0
            if fast < 1.0 and self.admission.pressure > 0.0:
                # release only once consumption is back under the
                # sustainable rate (hysteresis between shed_burn and 1)
                self.admission.set_pressure(0.0)
                self.metrics.set_slo_pressure(0.0)
                logger.info(
                    "gateway %s: SLO burn subsided (fast %.2f); "
                    "admission pressure released", self.name, fast,
                )

    def slo_status(self) -> Optional[Dict]:
        """The burn state ``/readyz`` surfaces (None with no SLOs)."""
        if self.slo_monitor is None or self._latency_slo is None:
            return None
        return {
            "pressure": self.admission.pressure,
            "burn_rate": self.slo_monitor.burn_rates(
                self._latency_slo.name
            ),
            "breaching": self.slo_monitor.breaching(
                self._latency_slo.name
            ),
        }

    # -- the live autoscale loop -------------------------------------------

    def observed_sizes(self) -> Dict[int, int]:
        """The pool-wide request-size histogram (every lane's engine
        merged) — exactly what ``/metrics`` exports per lane as
        ``keystone_serving_request_size_total``."""
        merged: Dict[int, int] = {}
        for lane in self.pool.lanes:
            for size, count in (
                lane.engine.metrics.request_sizes.snapshot().items()
            ):
                merged[size] = merged.get(size, 0) + count
        return merged

    def observed_goodput(self) -> Dict:
        """Pool-wide LIVE goodput: valid vs padded rows every lane
        engine actually dispatched (the device-truth counters the
        padding-efficiency gauge exports per lane) — what a re-bucket
        decision is audited against."""
        goodput = padded = 0
        for lane in self.pool.lanes:
            m = lane.engine.metrics
            goodput += m.examples.total
            padded += m.padded_rows.total
        total = goodput + padded
        return {
            "goodput_rows": goodput,
            "padded_rows": padded,
            "efficiency": goodput / total if total else None,
        }

    def rebucket(self, force: bool = False) -> bool:
        """One autoscale iteration: histogram -> ``suggest_buckets`` ->
        build + warm replacements -> atomic swap -> old engines drain.
        Returns True when a swap happened. Unforced calls act only on
        enough evidence AND a changed proposal; ``force=True`` swaps
        unconditionally (same buckets if no better proposal — the smoke
        path and swap drills use this).

        Every swap is AUDITED: the observed goodput (live per-bucket
        valid/padded counters) under the outgoing bucket set and the
        model-predicted efficiency of the proposal are logged together
        and kept at ``last_rebucket_audit``, so a ``suggest_buckets``
        decision can be checked against what the traffic then actually
        did (the next audit's observed number)."""
        with self._swap_lock:
            hist = self.observed_sizes()
            observations = sum(hist.values())
            proposal = self._buckets
            if hist and (
                force or observations >= MIN_REBUCKET_OBSERVATIONS
            ):
                proposal = suggest_buckets(
                    hist, self._rebucket_k, max_bucket=self._buckets[-1]
                )
            if not force:
                if observations < MIN_REBUCKET_OBSERVATIONS:
                    return False
                if proposal == self._buckets:
                    return False
            observed = self.observed_goodput()
            audit = {
                "from_buckets": list(self._buckets),
                "to_buckets": list(proposal),
                "observations": observations,
                "observed_efficiency_before": observed["efficiency"],
                "goodput_rows_before": observed["goodput_rows"],
                "padded_rows_before": observed["padded_rows"],
                "predicted_efficiency_after": predicted_efficiency(
                    hist, proposal
                ),
            }
            if not self.swap_engines(proposal):
                # close() won the race: nothing rotated, so no audit,
                # no log line, and the caller (POST /swap) must not be
                # told a swap happened
                return False
            self.last_rebucket_audit = audit
            logger.info(
                "gateway %s rebucket %s -> %s: observed padding "
                "efficiency %s over %d goodput rows; proposal predicts "
                "%s on the observed histogram",
                self.name, audit["from_buckets"], audit["to_buckets"],
                _fmt_eff(audit["observed_efficiency_before"]),
                audit["goodput_rows_before"],
                _fmt_eff(audit["predicted_efficiency_after"]),
            )
            return True

    def build_engines(self, buckets: Sequence[int]) -> list:
        """Build + warm one replacement engine per lane with
        ``buckets`` — the warm-pool half of a swap. Runs outside the
        POOL's lock (so lanes keep serving and the pool stays
        closeable while the next generation captures) but under the
        gateway's swap lock when driven by ``swap_engines``: engine
        construction claims the per-lane metrics labels
        (newest-claim-wins), so two generations building concurrently
        could rotate in an engine whose label another build claimed —
        one swap at a time stays the invariant. The engines come back
        with every bucket's graph captured, ready to rotate in."""
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        return self.pool.build_replacements(
            self._factory_for(buckets),
            warmup_example=self._warmup_example,
        )

    def build_model_batcher(self, fitted, *, name: str, aot_store=None) -> MicroBatcher:
        """One engine + micro-batcher for a DIFFERENT fitted pipeline
        over THIS gateway's serving config (buckets, device featurize,
        windowing) — the candidate plane the lifecycle loop points
        shadow and canary traffic at. Deliberately NOT a pool lane: the
        candidate serves copies/fractions, never owns routing, and is
        closed by its controller. With a warmup example every bucket's
        graph is captured here, so that no capture lands in the shadow
        or canary traffic. ``aot_store`` is the candidate's own (per
        version namespaced) store; None means none, so that a candidate
        never fills the incumbent's entries."""
        if self._engine_factory is not None:
            raise RuntimeError(
                f"gateway {self.name} runs on an engine-factory "
                "override (zoo CSE plane); its engines aren't "
                "buildable from a fitted pipeline"
            )
        engine = fitted.compiled(
            buckets=self._buckets,
            name=name,
            featurize=self._device_featurize,
            device=self._device,
            param_sharding=self._param_sharding,
            aot_store=aot_store if aot_store is not None else False,
        )
        if self._warmup_example is not None:
            engine.warmup(example=self._warmup_example)
        return MicroBatcher(
            engine,
            max_delay_ms=self._max_delay_ms,
            pipeline_depth=self._pipeline_depth,
            host_featurize=self._host_featurize,
        )

    def swap_model(self, fitted, *, aot_store=_UNCHANGED) -> bool:
        """Re-point the gateway at a DIFFERENT fitted pipeline and
        rotate every lane onto engines built from it — the promotion
        (and rollback) primitive: build + warm outside the pool lock,
        then the same atomic per-lane ``swap_engine`` a rebucket uses,
        so in-flight windows finish on the old model and nothing is
        dropped. Returns False when ``close()`` won the race (nothing
        rotated); on a build failure the previous fitted is restored
        and the old engines keep serving. Rolling BACK a promotion is
        just ``swap_model(incumbent)`` — engines recaptured from the
        identical fitted pipeline. ``aot_store``, when given, replaces
        the store the next engine generations consult (restored with
        the previous fitted pipeline on a failed build)."""
        if self._engine_factory is not None:
            raise RuntimeError(
                f"gateway {self.name} runs on an engine-factory "
                "override (zoo CSE plane); swap_model cannot rebuild "
                "its engines from a fitted pipeline"
            )
        with self._swap_lock:
            prev_fitted, prev_store = self.fitted, self._aot_store
            self.fitted = fitted
            if aot_store is not _UNCHANGED:
                self._aot_store = aot_store
            try:
                ok = self._build_and_swap(self._buckets)
            except Exception:
                self.fitted, self._aot_store = prev_fitted, prev_store
                raise
            if not ok:
                self.fitted, self._aot_store = prev_fitted, prev_store
            return ok

    def swap_engines(
        self, buckets: Sequence[int], background: bool = False
    ):
        """Rotate the next engine generation in: build + warm one
        replacement per lane (``build_engines`` — outside the pool
        lock) and atomically
        re-point every lane's batcher (in-flight windows finish on the
        old engines; queued and future requests use the new ones).

        ``background=True`` is the warm-pool mode: the build AND the
        rotation run on a background builder thread and the returned
        ``Future`` resolves True once the rotation happened (False if
        the gateway closed first; a build/swap failure lands on the
        future as its exception, with the old engines still serving).
        Synchronous calls return the same bool directly — False means
        a close() won the race and NOTHING rotated, which callers like
        ``rebucket`` must not report as a swap."""
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not background:
            return self._build_and_swap(buckets)
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self._build_and_swap(buckets))
            except Exception as e:
                logger.exception(
                    "gateway %s: background engine swap to %s failed "
                    "(old engines keep serving)", self.name, buckets,
                )
                fut.set_exception(e)

        threading.Thread(
            target=run, name=f"keystone-{self.name}-warmpool",
            daemon=True,
        ).start()
        return fut

    def _build_and_swap(self, buckets: tuple) -> bool:
        if self._closed:
            # already closed before the build even started: skip the
            # whole generation build (per-lane captures + metrics
            # label re-registration) for a gateway that's gone
            return False
        with self._swap_lock:
            # the BUILD happens under the swap lock too (re-entrant
            # from rebucket): builds claim the lane metrics labels at
            # engine construction, so build order must equal rotation
            # order — what stays unlocked is the POOL, which keeps
            # serving and closeable throughout. That makes this a
            # deliberate blocking-under-lock exception: _swap_lock is
            # the coarse one-swap-at-a-time maintenance lock, held by
            # nothing on the request plane.
            engines = self.build_engines(buckets)  # lint: disable=blocking-under-lock
            if self._closed:
                # a background build that lost the race with close():
                # the fresh engines are dropped, nothing rotated
                return False
            try:
                displaced = self.pool.swap(
                    self._factory_for(buckets), engines=engines
                )
            except RuntimeError:
                if self._closed:
                    # close() won the race between our check and the
                    # pool's own: a normal shutdown, not a swap failure
                    return False
                raise
            self._buckets = buckets
            # the windows the lanes took before the swap finish on the
            # displaced engines; then their graphs and pools go
            for engine in displaced:
                engine.retire()
        return True

    def _chaos_forced_swap(self, spec) -> None:
        """``gateway.swap.force`` trigger body (injector background
        thread): one forced live swap, mid-whatever-load-is-running."""
        if self._closed:
            return
        logger.warning(
            "gateway %s: chaos-forced live swap (fault point armed)",
            self.name,
        )
        try:
            self.rebucket(force=True)
        except Exception:
            # chaos must surface as symptoms, not crash the trigger
            # thread: the old engines keep serving on a failed swap
            logger.exception(
                "gateway %s: chaos-forced swap failed", self.name
            )

    def _maintenance_loop(self, interval_s: float) -> None:
        while not self._maint_stop.wait(interval_s):
            try:
                if self.rebucket():
                    logger.info(
                        "gateway %s rebucketed to %s",
                        self.name, self._buckets,
                    )
            except Exception:
                # the loop must survive a failed proposal/build — the
                # old engines keep serving either way
                logger.exception("gateway %s rebucket failed", self.name)

    # -- shutdown ----------------------------------------------------------

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Graceful drain: flip readiness, stop admitting (typed
        ``Overloaded('closed')`` for new arrivals), drain the admission
        queue into the lanes, flush every micro-batcher, and stop the
        maintenance loop. Already-admitted requests resolve. Safe to
        call concurrently: every caller returns only once the drain has
        finished (the SIGTERM/`/drain` thread and the serve loop's own
        close must not race the process exit past in-flight work)."""
        with self._close_lock:
            first = not self._closed
            self._closed = True
        if not first:
            self._drained.wait(timeout)
            return
        # a retired gateway must stop receiving chaos triggers
        self._chaos_unregister()
        self._maint_stop.set()
        if self.slo_monitor is not None:
            self.slo_monitor.stop()
        self.admission.close(timeout=timeout)
        self.pool.close(timeout=timeout)
        if self._maint is not None:
            self._maint.join(timeout=1.0)
        self._drained.set()
        logger.info("gateway %s drained and closed", self.name)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (main thread only; serving
        CLIs call this, libraries shouldn't)."""

        def handle(signum, frame):
            logger.info(
                "gateway %s: signal %d, draining", self.name, signum
            )
            threading.Thread(
                target=self.close, name=f"keystone-{self.name}-drain",
                daemon=True,
            ).start()

        signal.signal(signal.SIGTERM, handle)
        signal.signal(signal.SIGINT, handle)

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["Gateway", "Overloaded", "MIN_REBUCKET_OBSERVATIONS"]
