"""Serving observability (counterpart of ``keystone_tpu/serving/metrics.py``,
ported in full).

One ``ServingMetrics`` instance rides along with each engine (and is
shared with its ``MicroBatcher``): per-bucket compile counts — in the
port, CUDA graph captures (``record_trace``), at most one per bucket and
example spec, the number the bucketed design exists to bound —
per-bucket dispatch counts, padded-vs-valid example counts (padding
waste), the observed per-request size histogram (what the bucket
autoscaler reads), dispatch and end-to-end request latency percentiles,
and a queue-depth gauge.

Device truth rides on the same instance: the engine injects the
detected device peaks (``observability/device.py``,
``set_device_peaks``). The rolling **MFU** gauge and the per-bucket
**roofline** classification also need a bucket program's cost model
(``set_cost_model``: FLOPs and bytes per dispatch); the JAX engine reads
it from XLA's cost analysis, the port's engine counts it in a bucket's
first eager run (``observability/device.CostCounter``). Without a cost
model or peaks those series stay ABSENT — never zeros, never errors.

Pipelined-lane serving (``serving/pipeline.py``) adds per-stage series:
a seconds recorder per stage (``host_prep``/``upload``/``compute``/
``deliver``), per-stage handoff-queue depth gauges, a windows-completed
counter, and the derived *bottleneck attribution* — the stage whose
standalone rate (1 / mean stage seconds) is lowest — plus
``overlap_efficiency`` = sustained window rate over that bottleneck
stage's rate (≈1.0 means the lane loses nothing to serialization;
meaningful under saturation, it decays with idle gaps like every
windowed rate here).

Built on the generic ``Counter`` / ``LatencyRecorder`` primitives in
``utils/profiling.py``, and bridged into the process-global
``MetricsRegistry`` (``register()``; ``CompiledPipeline`` does this on
construction) so a scrape (``observability/prometheus.render``) exports
every engine's counters under an ``engine`` label. The bridge holds only
a weakref: an engine going out of scope unregisters itself at the next
scrape.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
import weakref
from typing import Deque, Dict, Optional, Tuple

from keystone_tpu_torch.utils.profiling import Counter, LatencyRecorder

# default sliding window of the instantaneous throughput gauge
RATE_WINDOW_S = 30.0

# the staged lane pipeline's stages, in flow order (serving/pipeline.py);
# bottleneck attribution ranges over these
PIPELINE_STAGES = ("host_prep", "upload", "compute", "deliver")

_engine_ids = itertools.count()


class ServingMetrics:
    def __init__(
        self, latency_window: int = 4096, clock=time.perf_counter
    ):
        # every windowed-rate gauge reads this clock; tests inject a
        # fake to make "a window elapsed" a statement instead of a
        # sleep (the real-sleep versions divided by tiny lifetimes and
        # flaked whenever a loaded CI host stretched the gap between
        # record and read)
        self._clock = clock
        # bucket -> number of CUDA graph captures (the port's compiles)
        self.compiles = Counter()
        # bucket -> number of compiled-program dispatches
        self.dispatches = Counter()
        # goodput accounting, PER BUCKET: valid examples served vs
        # padded rows shipped (cells keyed by bucket; ``.total`` is the
        # engine-wide number the summary/bench read)
        self.examples = Counter()
        self.padded_rows = Counter()
        # bytes actually staged to the device, per bucket (padding
        # included — padding rides the H2D path like any row). The
        # device-featurize win — raw uint8 on the wire instead of f32
        # features — is this counter's ratio, not a claim.
        self.h2d_bytes = Counter()
        # bucket -> static cost model ({flops, bytes_accessed,
        # temp_bytes, ...}); the port's engine has none to register,
        # so the derived MFU/roofline series stay absent
        self.cost_models: Dict[int, Dict[str, float]] = {}
        # modeled device FLOPs dispatched (lifetime; absent until a
        # cost model exists for a dispatched bucket)
        self.device_flops = Counter()
        # detected device peaks (observability/device.py); None =
        # unknown hardware -> MFU/roofline series stay absent
        self._peak_flops: Optional[float] = None
        self._peak_membw: Optional[float] = None
        self._n_devices: int = 1
        # live host staging-buffer bytes (HostBufferPool); None until a
        # pipelined lane runs
        self._staging_bytes: Optional[int] = None  # guarded-by: _lock
        # valid-row count of each dispatch (the observed request-size
        # histogram serving/autoscale.py proposes bucket sets from)
        self.request_sizes = Counter()
        # COMPLETION-timed dispatch wall time: staging through the
        # compiled program's results being ready, recorded at an
        # explicit sync point (``apply(sync=True)`` / the pipelined
        # compute stage). The old enqueue-only number under-reported
        # device time (execution is async past the compiled call);
        # it survives as its own series below.
        self.dispatch_latency = LatencyRecorder(latency_window)
        # ENQUEUE-only dispatch time: pad/placement + compiled-call
        # dispatch, excluding device execution (plus the graph capture
        # on a bucket's FIRST dispatch; warmup moves that out of traffic).
        self.dispatch_enqueue_latency = LatencyRecorder(latency_window)
        # staged-lane pipeline stage seconds (busy time per window per
        # stage) + per-stage handoff-queue depths + completed windows
        self.stage_seconds: Dict[str, LatencyRecorder] = {
            s: LatencyRecorder(latency_window) for s in PIPELINE_STAGES
        }
        self.windows = Counter()
        self._stage_queue_depth: Dict[str, int] = {}  # guarded-by: _lock
        # (timestamp,) per completed pipeline window, pruned like
        # _rate_events: the sustained-window-rate input of the
        # overlap-efficiency gauge
        self._window_events: Deque[float] = (
            collections.deque()
        )  # guarded-by: _lock
        # enqueue-to-future-resolution time of micro-batched requests
        self.request_latency = LatencyRecorder(latency_window)
        self._queue_depth = 0  # guarded-by: _lock
        self._coalesced_max = 0  # guarded-by: _lock
        # (timestamp, valid, padded, modeled flops) per dispatch,
        # pruned to the rate window: the windowed examples/sec,
        # padding-efficiency, and MFU gauges all read this, so idle
        # periods decay to zero instead of diluting a lifetime average
        self._rate_events: Deque[
            Tuple[float, int, int, float]
        ] = collections.deque()  # guarded-by: _lock
        self._lock = threading.Lock()
        self._t0 = self._clock()
        # optional per-model attribution binding
        # (observability/attribution.EngineAttribution): every dispatch
        # fact recorded here is mirrored into the model-labeled ledger,
        # fair-split over shared engines. None (the default) keeps the
        # hot path untouched — one attribute check per dispatch.
        self._attribution = None

    # -- engine-side hooks -------------------------------------------------

    def attach_attribution(self, binding) -> None:
        """Mirror this engine's dispatch facts into a per-model cost
        ledger (``observability/attribution.EngineAttribution``)."""
        self._attribution = binding

    def record_trace(self, bucket: int) -> None:
        self.compiles.inc(bucket)

    def record_dispatch(
        self,
        bucket: int,
        n_valid: int,
        seconds: Optional[float] = None,
        h2d_bytes: Optional[int] = None,
    ) -> None:
        """One compiled-program dispatch: counters + rate events.
        ``seconds``, when given, is a completion-timed wall number and
        feeds ``dispatch_latency`` directly (callers that only know the
        enqueue time use ``record_dispatch_enqueue`` and record the
        completion number at their sync point). ``h2d_bytes`` is the
        staged input tree's byte footprint — what this dispatch shipped
        host-to-device, padding included."""
        padded = bucket - n_valid
        self.dispatches.inc(bucket)
        self.examples.inc(bucket, n_valid)
        self.padded_rows.inc(bucket, padded)
        if h2d_bytes:
            self.h2d_bytes.inc(bucket, int(h2d_bytes))
        self.request_sizes.inc(n_valid)
        # modeled device work for this dispatch: the bucket program's
        # static cost is paid whether rows are valid or padding
        flops = self.cost_models.get(bucket, {}).get("flops", 0.0)
        if flops:
            self.device_flops.inc(None, flops)
        if seconds is not None:
            self.dispatch_latency.record(seconds)
        if self._attribution is not None:
            self._attribution.on_dispatch(
                bucket, n_valid, padded, flops, seconds, h2d_bytes
            )
        now = self._clock()
        with self._lock:
            self._rate_events.append((now, n_valid, padded, flops))
            cutoff = now - RATE_WINDOW_S
            while self._rate_events and self._rate_events[0][0] < cutoff:
                self._rate_events.popleft()

    def record_dispatch_enqueue(self, seconds: float) -> None:
        """Pad/placement + compiled-call dispatch time (no execution)."""
        self.dispatch_enqueue_latency.record(seconds)

    def record_dispatch_complete(self, seconds: float) -> None:
        """Completion-timed dispatch wall time, recorded at the sync
        point where the dispatched results became ready."""
        self.dispatch_latency.record(seconds)
        if self._attribution is not None:
            self._attribution.on_complete(seconds)

    # -- device-truth hooks (engine warmup / observability.device) ---------

    def set_cost_model(self, bucket: int, model: Dict[str, float]) -> None:
        """Register one bucket program's static cost model
        (the port's engine calls this with its counted run's model, the
        JAX engine with XLA's cost analysis). Empty models are dropped —
        absence of cost analysis must yield absent series."""
        if model:
            self.cost_models[int(bucket)] = dict(model)

    def set_device_peaks(
        self,
        peak_flops: Optional[float],
        peak_membw: Optional[float] = None,
        n_devices: int = 1,
    ) -> None:
        """Detected hardware peaks (``observability/device.peaks_for``)
        — the MFU denominator and the roofline ridge point. None means
        unknown hardware: the derived series stay absent."""
        self._peak_flops = peak_flops
        self._peak_membw = peak_membw
        self._n_devices = max(1, int(n_devices))

    def set_staging_bytes(self, nbytes: int) -> None:
        """Live host staging-buffer footprint (``HostBufferPool``)."""
        with self._lock:
            self._staging_bytes = int(nbytes)

    # -- pipeline-side hooks (serving/pipeline.py) -------------------------

    def record_stage(self, stage: str, seconds: float) -> None:
        rec = self.stage_seconds.get(stage)
        if rec is not None:
            rec.record(seconds)

    def set_stage_queue_depth(self, stage: str, depth: int) -> None:
        with self._lock:
            self._stage_queue_depth[stage] = depth

    def record_window(self) -> None:
        """One pipelined window fully delivered."""
        self.windows.inc(None)
        now = self._clock()
        with self._lock:
            self._window_events.append(now)
            cutoff = now - RATE_WINDOW_S
            while self._window_events and self._window_events[0] < cutoff:
                self._window_events.popleft()

    # -- batcher-side hooks ------------------------------------------------

    def set_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._queue_depth = depth

    def record_coalesce(self, size: int) -> None:
        with self._lock:
            self._coalesced_max = max(self._coalesced_max, size)

    def record_request(self, seconds: float) -> None:
        self.request_latency.record(seconds)

    # -- queries -----------------------------------------------------------

    @property
    def compile_count(self) -> int:
        return self.compiles.total

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._queue_depth

    @property
    def max_coalesced(self) -> int:
        with self._lock:
            return self._coalesced_max

    def examples_per_sec(self, window: float = RATE_WINDOW_S) -> float:
        """Windowed throughput: examples dispatched over the last
        ``window`` seconds (clamped to the instance's lifetime so a
        young engine isn't over-divided, and to ``RATE_WINDOW_S`` —
        events older than that are pruned at record time, so a larger
        window would silently divide a 30s sum by more than 30s). This
        is the gauge ``summary()`` and ``/metrics`` export — unlike the
        lifetime average it goes to zero when traffic stops instead of
        decaying slowly forever."""
        now = self._clock()
        window = min(window, RATE_WINDOW_S, max(now - self._t0, 1e-9))
        cutoff = now - window
        with self._lock:
            served = sum(
                ev[1] for ev in self._rate_events if ev[0] >= cutoff
            )
        return served / window

    def padding_efficiency(
        self, window: float = RATE_WINDOW_S
    ) -> Optional[float]:
        """Windowed goodput fraction: valid rows over all rows shipped
        (valid + padding) across the dispatches of the last ``window``
        seconds. The LIVE counterpart of the offline
        ``autoscale.padding_waste`` estimate — what actually went over
        the wire, not what the histogram model predicts. None with no
        dispatches in the window (absent gauge, not a fake 1.0)."""
        now = self._clock()
        window = min(window, RATE_WINDOW_S, max(now - self._t0, 1e-9))
        cutoff = now - window
        with self._lock:
            valid = padded = 0
            for ev in self._rate_events:
                if ev[0] >= cutoff:
                    valid += ev[1]
                    padded += ev[2]
        total = valid + padded
        return valid / total if total else None

    def flops_per_sec(self, window: float = RATE_WINDOW_S) -> float:
        """Windowed modeled device FLOP/s (zero until a dispatched
        bucket has a registered cost model)."""
        now = self._clock()
        window = min(window, RATE_WINDOW_S, max(now - self._t0, 1e-9))
        cutoff = now - window
        with self._lock:
            flops = sum(
                ev[3] for ev in self._rate_events if ev[0] >= cutoff
            )
        return flops / window

    def mfu(self, window: float = RATE_WINDOW_S) -> Optional[float]:
        """Rolling model FLOPs utilization: windowed modeled FLOP/s
        over the device set's peak FLOP/s (the PaLM-report convention).
        None when the hardware peak is unknown or no dispatched bucket
        carries a cost model — absent series, never a made-up zero."""
        if not self._peak_flops or not self.cost_models:
            return None
        return self.flops_per_sec(window) / (
            self._peak_flops * self._n_devices
        )

    def roofline_bound(self, bucket: int) -> Optional[str]:
        """``"compute"`` or ``"bandwidth"`` for one bucket program:
        arithmetic intensity (modeled FLOPs per byte accessed) above or
        below the device's ridge point (peak FLOP/s over peak memory
        bandwidth). None without a cost model or known peaks."""
        model = self.cost_models.get(bucket)
        if (
            not model
            or not self._peak_flops
            or not self._peak_membw
            or not model.get("bytes_accessed")
            or "flops" not in model
        ):
            return None
        intensity = model["flops"] / model["bytes_accessed"]
        ridge = self._peak_flops / self._peak_membw
        return "compute" if intensity >= ridge else "bandwidth"

    @property
    def staging_bytes(self) -> Optional[int]:
        with self._lock:
            return self._staging_bytes

    # -- pipeline attribution (the streaming bench's model, per lane) ------

    def stage_rates(self) -> Dict[str, float]:
        """Windows/sec each stage could sustain STANDALONE, from its
        mean busy seconds per window (1 / mean) — the per-lane analogue
        of the streaming featurize bench's standalone stage probes."""
        rates: Dict[str, float] = {}
        for stage, rec in self.stage_seconds.items():
            snap = rec.snapshot()
            if snap["count"] and snap["total"] > 0:
                rates[stage] = snap["count"] / snap["total"]
        return rates

    def bottleneck(self) -> Optional[Tuple[str, float]]:
        """``(stage, rate)`` of the slowest stage — the same min-rate
        attribution the streaming bench reports as ``bottleneck`` —
        or None before any pipelined window ran."""
        rates = self.stage_rates()
        if not rates:
            return None
        stage = min(rates, key=rates.get)
        return stage, rates[stage]

    def windows_per_sec(self, window: float = RATE_WINDOW_S) -> float:
        """Sustained pipelined-window completion rate (windowed like
        ``examples_per_sec``)."""
        now = self._clock()
        window = min(window, RATE_WINDOW_S, max(now - self._t0, 1e-9))
        cutoff = now - window
        with self._lock:
            n = sum(1 for t in self._window_events if t >= cutoff)
        return n / window

    def overlap_efficiency(self) -> Optional[float]:
        """Sustained window rate over the bottleneck stage's standalone
        rate: ~1.0 means the lane pipeline loses nothing to
        serialization (can exceed 1.0 — stages measured under overlap
        run slower than they would standalone, making the model
        conservative, exactly like the streaming bench's caveat).
        Meaningful under saturation; decays toward 0 over idle gaps."""
        bn = self.bottleneck()
        if bn is None or bn[1] <= 0:
            return None
        return self.windows_per_sec() / bn[1]

    def pipeline_report(self) -> Optional[Dict]:
        """Per-stage seconds/rates + bottleneck attribution + overlap
        efficiency for this lane (None before any pipelined window)."""
        if not self.windows.total:
            return None
        rates = self.stage_rates()
        stages = {}
        for stage, rec in self.stage_seconds.items():
            snap = rec.snapshot()
            if not snap["count"]:
                continue
            stages[stage] = {
                "mean_ms": round(
                    snap["total"] / snap["count"] * 1e3, 3
                ),
                "p99_ms": round(snap["p99"] * 1e3, 3)
                if snap["p99"] is not None else None,
                "rate_per_s": round(rates.get(stage, 0.0), 1),
            }
        bn = self.bottleneck()
        eff = self.overlap_efficiency()
        with self._lock:
            queue_depths = dict(self._stage_queue_depth)
        return {
            "windows": self.windows.total,
            "windows_per_sec": round(self.windows_per_sec(), 2),
            "stages": stages,
            "stage_queue_depths": queue_depths,
            "bottleneck": bn[0] if bn else None,
            "overlap_efficiency": round(eff, 3) if eff is not None else None,
        }

    def examples_per_sec_lifetime(self) -> float:
        """LIFETIME average (examples since construction / wall time
        since construction) — it decays over idle periods and includes
        warmup, so it's a capacity sanity number, not an instantaneous
        throughput gauge. Benches that need a true rate time their own
        window (serving/bench.py does)."""
        dt = self._clock() - self._t0
        return self.examples.total / dt if dt > 0 else 0.0

    def summary(self) -> Dict:
        """Flat dict suitable for a bench row's ``extra`` or a log line."""

        def ms(v: Optional[float]) -> Optional[float]:
            return round(v * 1e3, 3) if v is not None else None

        dispatch = self.dispatch_latency.snapshot()
        enqueue = self.dispatch_enqueue_latency.snapshot()
        request = self.request_latency.snapshot()
        pipeline = self.pipeline_report()
        eff = self.padding_efficiency()
        mfu = self.mfu()
        out = {
            "compiles_per_bucket": {
                str(k): v for k, v in sorted(self.compiles.snapshot().items())
            },
            "dispatches_per_bucket": {
                str(k): v
                for k, v in sorted(self.dispatches.snapshot().items())
            },
            "examples": self.examples.total,
            "padded_rows": self.padded_rows.total,
            "h2d_bytes_total": self.h2d_bytes.total,
            "h2d_bytes_per_example": (
                round(self.h2d_bytes.total / self.examples.total, 1)
                if self.examples.total else None
            ),
            "padding_efficiency": (
                round(eff, 4) if eff is not None else None
            ),
            "device_flops_total": self.device_flops.total,
            "mfu": round(mfu, 6) if mfu is not None else None,
            "examples_per_sec": round(self.examples_per_sec(), 1),
            "examples_per_sec_lifetime": round(
                self.examples_per_sec_lifetime(), 1
            ),
            "dispatch_p50_ms": ms(dispatch["p50"]),
            "dispatch_p95_ms": ms(dispatch["p95"]),
            "dispatch_p99_ms": ms(dispatch["p99"]),
            "dispatch_enqueue_p50_ms": ms(enqueue["p50"]),
            "request_p50_ms": ms(request["p50"]),
            "request_p95_ms": ms(request["p95"]),
            "request_p99_ms": ms(request["p99"]),
            "queue_depth": self.queue_depth,
            "max_coalesced": self.max_coalesced,
        }
        if pipeline is not None:
            out["pipeline"] = pipeline
        return out

    # -- MetricsRegistry bridge --------------------------------------------

    def register(self, registry=None, engine: Optional[str] = None) -> str:
        """Export this instance's live state through a ``MetricsRegistry``
        (the process-global one by default) under an ``engine`` label.

        Registers a weakref-holding collector: nothing is copied until a
        scrape, the hot-path record_* methods are untouched, and once
        the engine (and its metrics) are garbage-collected the collector
        returns None and is pruned. Returns the engine label used.

        Idempotent against the global registry: a second global
        ``register()`` (e.g. an engine wrapping caller-provided metrics
        that already registered) returns the existing label instead of
        double-exporting every family.

        Label ownership: registering a label that a still-live
        ``ServingMetrics`` already claimed in the same registry
        TRANSFERS it — the newest registration wins and the superseded
        collector prunes itself at the next scrape. That keeps the
        documented engine-swap loop (build replacement under the same
        name, warm, swap) from ever emitting duplicate series, which
        Prometheus rejects scrape-wide."""
        from keystone_tpu_torch.observability.registry import (
            MetricFamily,
            Sample,
            get_global_registry,
        )

        if registry is None and getattr(self, "_registered_label", None):
            return self._registered_label
        reg = registry if registry is not None else get_global_registry()
        label = engine if engine is not None else f"engine{next(_engine_ids)}"
        if registry is None:
            self._registered_label = label
        ref = weakref.ref(self)
        # per-registry label claim table: collector emits only while it
        # is the label's CURRENT owner
        claims = getattr(reg, "_engine_label_claims", None)
        if claims is None:
            claims = reg._engine_label_claims = {}
        claims[label] = ref

        def quantile_samples(rec: LatencyRecorder):
            snap = rec.snapshot()
            out = [
                Sample(
                    "",
                    {"engine": label, "quantile": repr(q)},
                    snap[f"p{int(q * 100)}"],
                )
                for q in (0.5, 0.95, 0.99)
                if snap[f"p{int(q * 100)}"] is not None
            ]
            out.append(Sample("_count", {"engine": label}, snap["count"]))
            out.append(Sample("_sum", {"engine": label}, snap["total"]))
            return out

        def stage_families(m):
            """Pipelined-lane families — emitted only once a staged
            pipeline has run on this engine, so serial engines' scrapes
            stay free of empty stage series."""
            if not m.windows.total:
                return []
            quantiles = []
            for stage, rec in sorted(m.stage_seconds.items()):
                snap = rec.snapshot()
                if not snap["count"]:
                    continue
                quantiles.extend(
                    Sample(
                        "",
                        {
                            "engine": label,
                            "stage": stage,
                            "quantile": repr(q),
                        },
                        snap[f"p{int(q * 100)}"],
                    )
                    for q in (0.5, 0.95, 0.99)
                    if snap[f"p{int(q * 100)}"] is not None
                )
                quantiles.append(Sample(
                    "_count", {"engine": label, "stage": stage},
                    snap["count"],
                ))
                quantiles.append(Sample(
                    "_sum", {"engine": label, "stage": stage},
                    snap["total"],
                ))
            bn = m.bottleneck()
            eff = m.overlap_efficiency()
            with m._lock:
                depths = dict(m._stage_queue_depth)
            return [
                MetricFamily(
                    "keystone_serving_stage_seconds", "summary",
                    "staged-lane pipeline busy seconds per window, "
                    "per stage",
                    quantiles,
                ),
                MetricFamily(
                    "keystone_serving_stage_queue_depth", "gauge",
                    "staged-lane handoff queue depth, per stage",
                    [
                        Sample(
                            "", {"engine": label, "stage": s}, d
                        )
                        for s, d in sorted(depths.items())
                    ],
                ),
                MetricFamily(
                    "keystone_serving_pipeline_windows_total", "counter",
                    "windows fully delivered by the staged lane pipeline",
                    [Sample("", {"engine": label}, m.windows.total)],
                ),
                MetricFamily(
                    "keystone_serving_pipeline_bottleneck", "gauge",
                    "1 on the stage with the lowest standalone rate "
                    "(the lane's bottleneck attribution)",
                    [
                        Sample(
                            "", {"engine": label, "stage": s},
                            1.0 if bn and s == bn[0] else 0.0,
                        )
                        for s in sorted(m.stage_seconds)
                    ],
                ),
                MetricFamily(
                    "keystone_serving_pipeline_overlap_efficiency",
                    "gauge",
                    "sustained window rate over the bottleneck stage's "
                    "standalone rate (~1.0 = nothing lost to "
                    "serialization)",
                    [Sample(
                        "", {"engine": label},
                        eff if eff is not None else 0.0,
                    )],
                ),
            ]

        def device_families(m):
            """Device-truth families — static cost models, rolling MFU,
            roofline classification, goodput. Every family is emitted
            only when its inputs exist (cost analysis present, peaks
            known, pool live): a backend that reports nothing yields
            ABSENT series, the graceful-degradation contract."""
            fams = []
            models = dict(m.cost_models)
            if models:
                per_key = (
                    ("flops", "keystone_device_flops_per_dispatch",
                     "modeled FLOPs per dispatch of the bucket's "
                     "compiled program"),
                    ("bytes_accessed", "keystone_device_bytes_per_dispatch",
                     "modeled bytes accessed per dispatch of the "
                     "bucket's compiled program"),
                    ("temp_bytes", "keystone_device_temp_hbm_bytes",
                     "temp (scratch) device memory of the bucket's "
                     "compiled program"),
                )
                for key, name, help_ in per_key:
                    samples = [
                        Sample(
                            "", {"engine": label, "bucket": str(b)},
                            mod[key],
                        )
                        for b, mod in sorted(models.items())
                        if key in mod
                    ]
                    if samples:
                        fams.append(
                            MetricFamily(name, "gauge", help_, samples)
                        )
                roofline = [
                    (b, m.roofline_bound(b)) for b in sorted(models)
                ]
                roofline = [(b, r) for b, r in roofline if r is not None]
                if roofline:
                    fams.append(MetricFamily(
                        "keystone_device_roofline_bound", "gauge",
                        "1 on the bucket program's roofline side "
                        "(arithmetic intensity vs the device ridge "
                        "point): compute- or bandwidth-bound",
                        [
                            Sample(
                                "",
                                {
                                    "engine": label,
                                    "bucket": str(b),
                                    "bound": side,
                                },
                                1.0 if side == r else 0.0,
                            )
                            for b, r in roofline
                            for side in ("compute", "bandwidth")
                        ],
                    ))
            if m.device_flops.total:
                fams.append(MetricFamily(
                    "keystone_serving_device_flops_total", "counter",
                    "modeled device FLOPs dispatched (per the buckets' "
                    "static cost models)",
                    [Sample("", {"engine": label}, m.device_flops.total)],
                ))
            mfu = m.mfu()
            if mfu is not None:
                fams.append(MetricFamily(
                    "keystone_serving_mfu", "gauge",
                    "rolling model FLOPs utilization: windowed modeled "
                    "FLOP/s over detected peak FLOP/s",
                    [Sample("", {"engine": label}, mfu)],
                ))
            eff = m.padding_efficiency()
            if eff is not None:
                fams.append(MetricFamily(
                    "keystone_serving_padding_efficiency", "gauge",
                    "windowed goodput fraction: valid rows over all "
                    "rows shipped (valid + padding)",
                    [Sample("", {"engine": label}, eff)],
                ))
            staging = m.staging_bytes
            if staging is not None:
                fams.append(MetricFamily(
                    "keystone_serving_staging_bytes", "gauge",
                    "live host staging-buffer bytes held by the lane's "
                    "buffer pool (pooled + in flight)",
                    [Sample("", {"engine": label}, staging)],
                ))
            return fams

        def collect():
            m = ref()
            if m is None or claims.get(label) is not ref:
                return None  # engine gone or label re-claimed by a
                # newer engine: prune this collector
            return stage_families(m) + device_families(m) + [
                MetricFamily(
                    "keystone_serving_compiles_total", "counter",
                    "CUDA graph captures per bucket",
                    [
                        Sample("", {"engine": label, "bucket": str(b)}, v)
                        for b, v in sorted(m.compiles.snapshot().items())
                    ],
                ),
                MetricFamily(
                    "keystone_serving_dispatches_total", "counter",
                    "compiled-program dispatches per bucket",
                    [
                        Sample("", {"engine": label, "bucket": str(b)}, v)
                        for b, v in sorted(m.dispatches.snapshot().items())
                    ],
                ),
                MetricFamily(
                    "keystone_serving_examples_total", "counter",
                    "valid examples served",
                    [Sample("", {"engine": label}, m.examples.total)],
                ),
                MetricFamily(
                    "keystone_serving_goodput_rows_total", "counter",
                    "valid (non-padding) rows dispatched, per bucket",
                    [
                        Sample("", {"engine": label, "bucket": str(b)}, v)
                        for b, v in sorted(m.examples.snapshot().items())
                    ],
                ),
                MetricFamily(
                    "keystone_serving_padded_rows_total", "counter",
                    "padded rows shipped (bucket waste), per bucket",
                    [
                        Sample("", {"engine": label, "bucket": str(b)}, v)
                        for b, v in sorted(m.padded_rows.snapshot().items())
                    ],
                ),
                MetricFamily(
                    "keystone_serving_h2d_bytes_total", "counter",
                    "bytes staged host-to-device per dispatch, by "
                    "bucket (padding included; raw-on-the-wire "
                    "device-featurize engines show the reduction here)",
                    [
                        Sample("", {"engine": label, "bucket": str(b)}, v)
                        for b, v in sorted(m.h2d_bytes.snapshot().items())
                    ],
                ),
                MetricFamily(
                    "keystone_serving_request_size_total", "counter",
                    "dispatches by valid-row count (autoscaler input)",
                    [
                        Sample("", {"engine": label, "size": str(s)}, v)
                        for s, v in sorted(m.request_sizes.snapshot().items())
                    ],
                ),
                MetricFamily(
                    "keystone_serving_queue_depth", "gauge",
                    "micro-batcher pending requests",
                    [Sample("", {"engine": label}, m.queue_depth)],
                ),
                MetricFamily(
                    "keystone_serving_examples_per_sec", "gauge",
                    f"windowed throughput over the last {RATE_WINDOW_S:.0f}s",
                    [Sample("", {"engine": label}, m.examples_per_sec())],
                ),
                MetricFamily(
                    "keystone_serving_dispatch_latency_seconds", "summary",
                    "engine dispatch wall time, completion-timed at the "
                    "caller's sync point",
                    quantile_samples(m.dispatch_latency),
                ),
                MetricFamily(
                    "keystone_serving_dispatch_enqueue_seconds", "summary",
                    "engine dispatch enqueue time (pad/placement + "
                    "compiled-call dispatch, execution excluded)",
                    quantile_samples(m.dispatch_enqueue_latency),
                ),
                MetricFamily(
                    "keystone_serving_request_latency_seconds", "summary",
                    "end-to-end micro-batched request latency",
                    quantile_samples(m.request_latency),
                ),
            ]

        reg.register_collector(collect)
        return label
