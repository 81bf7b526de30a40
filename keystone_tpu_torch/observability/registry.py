"""Process-global metrics registry (counterpart of
``keystone_tpu/observability/registry.py``, copied as it is: the module
is framework-free).

One named, labeled catalogue of counters / gauges / latency summaries
that every subsystem publishes into and every exporter reads out of —
in the port, the serving engine, the micro-batcher and the fault
injector feed it, and ``observability/prometheus.py`` renders it.

Built on the existing thread-safe primitives in ``utils/profiling.py``:
a registry counter is a ``Counter`` whose cells are keyed by
label-value tuples; a latency summary is one ``LatencyRecorder`` per
label set. Gauges come in two flavours — settable (a locked float per
label set) and callback-backed (a zero-state function polled at collect
time, so live objects like a ``ServingMetrics`` never copy state into
the registry on the hot path).

Collection is pull-based: ``collect()`` snapshots every metric into
``MetricFamily`` records. Live objects can also register a *collector*
callback (held by weakref via a closure, so registration never extends
an engine's lifetime) that yields families at scrape time.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import threading
import time
from typing import (
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

from keystone_tpu_torch.utils.profiling import Counter, LatencyRecorder

LabelValues = Tuple[str, ...]

# quantiles a latency summary exports (matches LatencyRecorder's
# p50/p95/p99 surface; Prometheus summary convention)
SUMMARY_QUANTILES = (0.5, 0.95, 0.99)

# default `le` bounds of a RegistryHistogram, tuned for request/queue
# latencies in seconds: sub-ms through 10s, roughly 2.5x apart
DEFAULT_HISTOGRAM_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


@dataclasses.dataclass
class Exemplar:
    """An OpenMetrics exemplar: one concrete observation (typically
    carrying a ``trace_id``) pinned to a histogram bucket, so the
    bucket's aggregate links back to a forensic trace."""

    labels: Dict[str, str]  # e.g. {"trace_id": "4bf9..."}
    value: float  # the exemplified observation itself
    timestamp_s: float  # epoch seconds when it was observed


@dataclasses.dataclass
class Sample:
    """One exposition line: ``name+suffix{labels} value``."""

    suffix: str  # "" for the bare metric, "_count"/"_sum" for summaries
    labels: Dict[str, str]
    value: float
    exemplar: Optional[Exemplar] = None


@dataclasses.dataclass
class MetricFamily:
    """A snapshot of one metric and all its label cells."""

    name: str
    mtype: str  # "counter" | "gauge" | "summary"
    help: str
    samples: List[Sample]


def _label_dict(
    labelnames: Sequence[str], values: LabelValues
) -> Dict[str, str]:
    return dict(zip(labelnames, values))


class _Metric:
    def __init__(self, name: str, help: str, labelnames: Sequence[str]):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)

    def _check(self, labels: Optional[LabelValues]) -> LabelValues:
        values = tuple(str(v) for v in (labels or ()))
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, "
                f"got values {values}"
            )
        return values


class RegistryCounter(_Metric):
    """Monotonic counter; cells keyed by label-value tuples."""

    mtype = "counter"

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames)
        self._cells = Counter()

    def inc(self, labels: Optional[LabelValues] = None, by: float = 1):
        if by < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self._cells.inc(self._check(labels), by)

    def get(self, labels: Optional[LabelValues] = None) -> float:
        return self._cells.get(self._check(labels))

    def collect(self) -> MetricFamily:
        cells = self._cells.snapshot()
        return MetricFamily(
            self.name, self.mtype, self.help,
            [
                Sample("", _label_dict(self.labelnames, values), v)
                for values, v in sorted(cells.items())
            ],
        )


class RegistryGauge(_Metric):
    """Settable gauge; one locked float per label set."""

    mtype = "gauge"

    def __init__(self, name, help, labelnames):
        super().__init__(name, help, labelnames)
        self._cells: Dict[LabelValues, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Optional[LabelValues] = None):
        with self._lock:
            self._cells[self._check(labels)] = float(value)

    def get(self, labels: Optional[LabelValues] = None) -> Optional[float]:
        with self._lock:
            return self._cells.get(self._check(labels))

    def collect(self) -> MetricFamily:
        with self._lock:
            cells = dict(self._cells)
        return MetricFamily(
            self.name, self.mtype, self.help,
            [
                Sample("", _label_dict(self.labelnames, values), v)
                for values, v in sorted(cells.items())
            ],
        )


class RegistryFuncGauge(_Metric):
    """Callback-backed gauge: ``fn`` runs at collect time and returns
    either a float (unlabeled) or a dict of label-values tuple ->
    float. Zero state, zero hot-path cost."""

    mtype = "gauge"

    def __init__(self, name, help, labelnames, fn: Callable):
        super().__init__(name, help, labelnames)
        self._fn = fn

    def collect(self) -> MetricFamily:
        out = self._fn()
        if not isinstance(out, dict):
            out = {(): out}
        samples = [
            Sample(
                "",
                _label_dict(
                    self.labelnames, tuple(str(v) for v in values)
                ),
                float(v),
            )
            for values, v in sorted(out.items())
            if v is not None
        ]
        return MetricFamily(self.name, self.mtype, self.help, samples)


class RegistrySummary(_Metric):
    """Latency summary: one ``LatencyRecorder`` per label set, exported
    as Prometheus quantile samples plus ``_count``/``_sum``."""

    mtype = "summary"

    def __init__(self, name, help, labelnames, window: int = 4096):
        super().__init__(name, help, labelnames)
        self._window = window
        self._cells: Dict[LabelValues, LatencyRecorder] = {}
        self._lock = threading.Lock()

    def recorder(
        self, labels: Optional[LabelValues] = None
    ) -> LatencyRecorder:
        """The live recorder for one label set (cacheable by callers so
        the per-observation path is one deque append)."""
        values = self._check(labels)
        with self._lock:
            rec = self._cells.get(values)
            if rec is None:
                rec = self._cells[values] = LatencyRecorder(self._window)
            return rec

    def observe(self, seconds: float, labels: Optional[LabelValues] = None):
        self.recorder(labels).record(seconds)

    def collect(self) -> MetricFamily:
        with self._lock:
            cells = dict(self._cells)
        samples: List[Sample] = []
        for values, rec in sorted(cells.items()):
            snap = rec.snapshot()
            base = _label_dict(self.labelnames, values)
            for q in SUMMARY_QUANTILES:
                v = snap[f"p{int(q * 100)}"]
                if v is not None:
                    samples.append(
                        Sample("", {**base, "quantile": repr(q)}, v)
                    )
            samples.append(Sample("_count", base, snap["count"]))
            samples.append(Sample("_sum", base, snap["total"]))
        return MetricFamily(self.name, self.mtype, self.help, samples)


class RegistryHistogram(_Metric):
    """Native Prometheus histogram: cumulative ``le``-bucket counts plus
    ``_sum``/``_count`` per label set.

    Unlike ``RegistrySummary`` (whose client-side quantiles cannot be
    aggregated across scrapes or instances), histogram buckets ADD —
    ``histogram_quantile(0.99, sum by (le) (rate(...)))`` is exact
    across every gateway/lane/host publishing the same family, which is
    why the gateway's queue-wait and request-latency series use this
    type. Observation is O(log buckets) (one bisect + one lock)."""

    mtype = "histogram"

    def __init__(
        self,
        name,
        help,
        labelnames,
        buckets: Sequence[float] = DEFAULT_HISTOGRAM_BUCKETS,
    ):
        super().__init__(name, help, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket")
        if not all(math.isfinite(b) for b in bounds):
            # +Inf is implicit (collect() always appends it); accepting
            # an explicit inf bound would emit a duplicate le="+Inf"
            # series, which Prometheus rejects scrape-wide
            raise ValueError(
                f"histogram {name} buckets must be finite (+Inf is "
                f"implicit): {bounds}"
            )
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name} buckets must be strictly ascending: "
                f"{bounds}"
            )
        self.bounds = bounds
        # per label set: ([per-bound counts..., +Inf overflow], sum,
        # {bucket idx -> Exemplar})
        self._cells: Dict[
            LabelValues, Tuple[List[int], List[float], Dict[int, Exemplar]]
        ] = {}
        self._lock = threading.Lock()

    def observe(
        self,
        value: float,
        labels: Optional[LabelValues] = None,
        trace_id: Optional[str] = None,
    ):
        """Record one observation. ``trace_id`` (when the caller is
        inside a traced request) pins this observation as the bucket's
        OpenMetrics exemplar — the scrape then links the aggregate
        bucket straight to the flight-recorder entry for that trace."""
        values = self._check(labels)
        value = float(value)
        idx = bisect.bisect_left(self.bounds, value)
        with self._lock:
            cell = self._cells.get(values)
            if cell is None:
                cell = self._cells[values] = (
                    [0] * (len(self.bounds) + 1), [0.0], {},
                )
            cell[0][idx] += 1
            cell[1][0] += value
            if trace_id:
                cell[2][idx] = Exemplar(
                    {"trace_id": str(trace_id)}, value, time.time()
                )

    def get_count(self, labels: Optional[LabelValues] = None) -> int:
        values = self._check(labels)
        with self._lock:
            cell = self._cells.get(values)
            return sum(cell[0]) if cell else 0

    # -- windowed readers (the SLO evaluator's inputs) ---------------------

    def le_index(self, threshold: float) -> int:
        """Index of the smallest bound >= ``threshold``
        (``len(bounds)`` means only +Inf covers it). The SLO layer uses
        this to snap a latency objective onto bucket resolution."""
        return bisect.bisect_left(self.bounds, float(threshold))

    def cumulative_count(
        self, bound_index: int, labels: Optional[LabelValues] = None
    ) -> int:
        """Observations <= ``bounds[bound_index]`` (cumulative ``le``
        semantics; an index past the last bound counts everything)."""
        values = self._check(labels)
        with self._lock:
            cell = self._cells.get(values)
            if cell is None:
                return 0
            return sum(cell[0][: bound_index + 1])

    def get_sum(self, labels: Optional[LabelValues] = None) -> float:
        values = self._check(labels)
        with self._lock:
            cell = self._cells.get(values)
            return cell[1][0] if cell else 0.0

    def collect(self) -> MetricFamily:
        with self._lock:
            cells = {
                k: (list(counts), totals[0], dict(exemplars))
                for k, (counts, totals, exemplars) in self._cells.items()
            }
        # local import: prometheus.py imports MetricFamily from here
        from keystone_tpu_torch.observability.prometheus import format_le

        samples: List[Sample] = []
        for values, (counts, total, exemplars) in sorted(cells.items()):
            base = _label_dict(self.labelnames, values)
            cum = 0
            for i, (bound, c) in enumerate(zip(self.bounds, counts)):
                cum += c
                samples.append(
                    Sample(
                        "_bucket", {**base, "le": format_le(bound)}, cum,
                        exemplar=exemplars.get(i),
                    )
                )
            cum += counts[-1]
            samples.append(
                Sample(
                    "_bucket", {**base, "le": "+Inf"}, cum,
                    exemplar=exemplars.get(len(self.bounds)),
                )
            )
            samples.append(Sample("_count", base, cum))
            samples.append(Sample("_sum", base, total))
        return MetricFamily(self.name, self.mtype, self.help, samples)


class MetricsRegistry:
    """The named catalogue. ``counter``/``gauge``/``gauge_func``/
    ``summary``/``histogram`` are get-or-create: re-registering the same
    name with the same type and labelnames returns the existing metric
    (subsystems in different modules can share a family); a mismatch
    raises."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], Iterable[MetricFamily]]] = []
        self._lock = threading.Lock()

    # -- registration ------------------------------------------------------

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (
                    type(existing) is not cls
                    or existing.labelnames != labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}{existing.labelnames}, "
                        f"asked for {cls.__name__}{labelnames}"
                    )
                return existing
            metric = cls(name, help, labelnames, **kw)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> RegistryCounter:
        return self._get_or_create(RegistryCounter, name, help, labelnames)

    def gauge(
        self, name: str, help: str = "", labelnames: Sequence[str] = ()
    ) -> RegistryGauge:
        return self._get_or_create(RegistryGauge, name, help, labelnames)

    def gauge_func(
        self,
        name: str,
        fn: Callable,
        help: str = "",
        labelnames: Sequence[str] = (),
    ) -> RegistryFuncGauge:
        return self._get_or_create(
            RegistryFuncGauge, name, help, labelnames, fn=fn
        )

    def summary(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        window: int = 4096,
    ) -> RegistrySummary:
        return self._get_or_create(
            RegistrySummary, name, help, labelnames, window=window
        )

    def histogram(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_HISTOGRAM_BUCKETS,
    ) -> RegistryHistogram:
        hist = self._get_or_create(
            RegistryHistogram, name, help, labelnames, buckets=buckets
        )
        if hist.bounds != tuple(float(b) for b in buckets):
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{hist.bounds}, asked for {tuple(buckets)}"
            )
        return hist

    def register_collector(
        self, fn: Callable[[], Optional[Iterable[MetricFamily]]]
    ) -> None:
        """A callback polled at collect time; return an iterable of
        ``MetricFamily`` or None to be pruned (the ServingMetrics
        bridge returns None once its engine is garbage-collected)."""
        with self._lock:
            self._collectors.append(fn)

    # -- scraping ----------------------------------------------------------

    def collect(self) -> List[MetricFamily]:
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        families = [m.collect() for m in metrics]
        dead = []
        for fn in collectors:
            out = fn()
            if out is None:
                dead.append(fn)
                continue
            families.extend(out)
        if dead:
            with self._lock:
                self._collectors = [
                    f for f in self._collectors if f not in dead
                ]
        # merge same-name families collectors may emit in parallel
        # (several engines export keystone_serving_* under different
        # engine labels) so exposition has one TYPE block per name
        merged: Dict[str, MetricFamily] = {}
        for fam in families:
            cur = merged.get(fam.name)
            if cur is None:
                merged[fam.name] = dataclasses.replace(
                    fam, samples=list(fam.samples)
                )
            else:
                cur.samples.extend(fam.samples)
        return list(merged.values())

    def varz(self) -> Dict:
        """The whole registry as one plain-JSON-able dict (``/varz``)."""
        out: Dict = {}
        for fam in self.collect():
            entry = out.setdefault(
                fam.name, {"type": fam.mtype, "help": fam.help, "values": []}
            )
            for s in fam.samples:
                entry["values"].append(
                    {
                        "suffix": s.suffix,
                        "labels": s.labels,
                        "value": s.value,
                    }
                )
        return out


_global_registry: Optional[MetricsRegistry] = None
_global_lock = threading.Lock()


def get_global_registry() -> MetricsRegistry:
    """The process-global registry every subsystem publishes into."""
    global _global_registry
    if _global_registry is None:
        with _global_lock:
            if _global_registry is None:
                _global_registry = MetricsRegistry()
    return _global_registry


def reset_global_registry() -> None:
    """Drop the process-global registry (tests)."""
    global _global_registry
    with _global_lock:
        _global_registry = None
