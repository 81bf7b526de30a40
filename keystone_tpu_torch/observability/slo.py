"""Declarative SLOs evaluated as multi-window burn rates (counterpart of
``keystone_tpu/observability/slo.py``, copied as it is).

KeystoneML's optimizer only acts on *measured* profiles; the serving
plane gets the same discipline for its objectives. An ``Slo`` is a
declarative target ("99% of requests under 250 ms", "99.9% of requests
succeed") read off the metric series the gateway already publishes
(``RegistryHistogram`` cumulative ``le`` buckets for latency,
``RegistryCounter`` cells for availability). The ``SloMonitor`` samples
those cumulative series on an interval and evaluates **burn rates**
over two windows (Google SRE multiwindow convention, fast ~1 m / slow
~30 m):

    burn = (bad fraction over window) / (1 - target)

so burn 1.0 consumes the error budget exactly at the sustainable rate,
and burn >> 1 means the budget is being torched *right now*. The fast
window reacts in seconds (the gateway's admission watchdog tightens the
queue on it — shed early, before saturation); the slow window confirms
the burn is sustained, filtering one-window blips.

Everything lands back on the observability plane: burn rates export as
``keystone_slo_burn_rate{slo,window}`` gauges (scrape-alertable), and
every live monitor is browsable at the admin endpoint's ``/slz``.
Nothing runs unless a monitor is constructed and started — zero
overhead for processes that never declare an objective.
"""

from __future__ import annotations

import logging
import math
import threading
import time
import weakref
from collections import deque
from typing import (
    Callable,
    Deque,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

from keystone_tpu_torch.observability.registry import (
    MetricsRegistry,
    RegistryCounter,
    RegistryHistogram,
    get_global_registry,
)

logger = logging.getLogger(__name__)

FAST_WINDOW_S = 60.0
SLOW_WINDOW_S = 1800.0

# every live SloMonitor, for /slz (weak: a closed gateway's monitor
# disappears from the listing with it)
_monitors: "weakref.WeakSet[SloMonitor]" = weakref.WeakSet()


def monitors() -> List["SloMonitor"]:
    """Every live monitor in the process (the ``/slz`` source)."""
    return list(_monitors)


def slz_status() -> Dict:
    """The admin ``/slz`` document: every SLO of every live monitor."""
    slos: List[Dict] = []
    for monitor in monitors():
        slos.extend(monitor.status()["slos"])
    return {"slos": sorted(slos, key=lambda s: s["name"])}


class Slo:
    """One objective: a name, a target fraction, and a ``read``
    callable returning the **cumulative** ``(total, bad)`` event counts
    since process start. The monitor turns successive reads into
    windowed deltas; this object stays pure declaration."""

    def __init__(
        self,
        name: str,
        target: float,
        read: Callable[[], Tuple[float, float]],
        *,
        description: str = "",
        threshold_s: Optional[float] = None,
    ):
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"SLO {name!r} target must be in (0, 1), got {target}"
            )
        self.name = name
        self.target = target
        self.budget = 1.0 - target
        self.read = read
        self.description = description
        self.threshold_s = threshold_s  # latency SLOs: the objective edge

    @classmethod
    def latency(
        cls,
        name: str,
        histogram: RegistryHistogram,
        threshold_s: float,
        target: float,
        labels: Sequence[str] = (),
    ) -> "Slo":
        """"``target`` of requests complete within ``threshold_s``",
        read from a native histogram's cumulative ``le`` buckets. The
        threshold snaps UP to bucket resolution (the smallest bound >=
        ``threshold_s``) — ``effective`` below is what is actually
        enforced, so declare thresholds on bucket edges for exactness.
        """
        labels = tuple(labels)
        idx = histogram.le_index(threshold_s)
        if idx >= len(histogram.bounds):
            # snapping to +Inf would count EVERY observation as good —
            # a dead objective that can never burn; fail loud instead
            raise ValueError(
                f"latency SLO {name!r} threshold {threshold_s}s exceeds "
                f"the histogram's largest bucket "
                f"({histogram.bounds[-1]}s) and would be unobservable"
            )
        effective = histogram.bounds[idx]

        def read() -> Tuple[float, float]:
            total = histogram.get_count(labels)
            good = histogram.cumulative_count(idx, labels)
            return float(total), float(total - good)

        return cls(
            name,
            target,
            read,
            description=(
                f"p{target * 100:g} latency <= {effective * 1e3:g}ms "
                f"(declared {threshold_s * 1e3:g}ms)"
            ),
            threshold_s=effective,
        )

    @classmethod
    def latency_from_buckets(
        cls,
        name: str,
        read_buckets: Callable[[], Sequence[Tuple[float, float]]],
        threshold_s: float,
        target: float,
    ) -> "Slo":
        """"``target`` of requests complete within ``threshold_s``",
        read from cumulative ``(le, count)`` buckets returned by
        ``read_buckets()`` — the FEDERATION path: a fleet router has
        no registry handle on its replicas' latency series, but it
        does have their scraped ``le`` buckets
        (``prometheus.histogram_buckets`` per replica merged by
        ``prometheus.merge_histograms``), and cumulative buckets are
        the same (total, bad) arithmetic as ``Slo.latency`` — so the
        fleet-wide burn rate is computed over exactly the series the
        replicas export, one ``SloMonitor`` above N processes.

        The threshold snaps UP to the smallest FINITE ``le`` bound >=
        ``threshold_s`` present in each read (same rule as
        ``Slo.latency``, applied per sample since the layout arrives
        with the data); an empty read reports ``(0, 0)`` — no fleet
        traffic yet, nothing burned. A threshold past every finite
        bound cannot raise at declaration time the way ``Slo.latency``
        does (the layout isn't known yet), so it clamps DOWN to the
        largest finite bound instead, with a one-time warning:
        snapping to ``+Inf`` would count every observation as good —
        a dead objective that can never burn — while the clamp keeps
        the SLO live (conservatively strict) and the warning points at
        the misdeclared threshold."""
        warned: List[str] = []  # one-time unobservable-threshold flag

        def read() -> Tuple[float, float]:
            buckets = list(read_buckets() or ())
            if not buckets:
                return 0.0, 0.0
            total = float(buckets[-1][1])
            good = None
            for le, count in buckets:
                if math.isinf(le):
                    continue
                if le >= threshold_s:
                    good = float(count)
                    break
            if good is None:
                finite = [
                    (le, c) for le, c in buckets if not math.isinf(le)
                ]
                if not finite:
                    return total, 0.0  # +Inf-only layout: unjudgeable
                if not warned:
                    warned.append(name)
                    logger.warning(
                        "SLO %s: threshold %gs exceeds the largest "
                        "finite bucket bound (%gs); clamping DOWN to "
                        "it — declare thresholds on bucket edges",
                        name, threshold_s, finite[-1][0],
                    )
                good = float(finite[-1][1])
            return total, total - good

        return cls(
            name,
            target,
            read,
            description=(
                f"p{target * 100:g} fleet latency <= "
                f"{threshold_s * 1e3:g}ms (federated le buckets)"
            ),
            threshold_s=threshold_s,
        )

    @classmethod
    def availability(
        cls,
        name: str,
        counter: RegistryCounter,
        target: float,
        *,
        base_labels: Sequence[str] = (),
        status_label_values: Sequence[str] = ("ok", "shed", "error"),
        bad_values: Sequence[str] = ("error",),
    ) -> "Slo":
        """"``target`` of requests end well", read from a labeled
        outcome counter (the gateway's
        ``keystone_gateway_requests_total{gateway,status}``): total is
        the sum across ``status_label_values`` appended to
        ``base_labels``; ``bad_values`` names the failing statuses."""
        base = tuple(base_labels)
        statuses = tuple(status_label_values)
        bad_set = tuple(bad_values)

        def read() -> Tuple[float, float]:
            by_status = {s: counter.get(base + (s,)) for s in statuses}
            return (
                float(sum(by_status.values())),
                float(sum(by_status[s] for s in bad_set)),
            )

        return cls(
            name,
            target,
            read,
            description=(
                f"{target * 100:g}% of requests avoid "
                f"{'/'.join(bad_set)} outcomes"
            ),
        )


class SloMonitor:
    """Samples every registered SLO's cumulative counts on a clock and
    evaluates fast/slow-window burn rates from the deltas.

    ``sample(now=...)`` is callable directly (tests drive synthetic
    clocks through it); ``start()`` runs it on a daemon thread. Each
    sample also publishes ``keystone_slo_burn_rate{slo,window}`` gauges
    and fires listeners — the gateway's admission watchdog is one."""

    def __init__(
        self,
        fast_window_s: float = FAST_WINDOW_S,
        slow_window_s: float = SLOW_WINDOW_S,
        registry: Optional[MetricsRegistry] = None,
    ):
        if not 0 < fast_window_s < slow_window_s:
            raise ValueError(
                f"need 0 < fast ({fast_window_s}) < slow "
                f"({slow_window_s}) window"
            )
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._slos: Dict[str, Slo] = {}
        # per SLO: (t, total, bad) cumulative samples, oldest first
        self._samples: Dict[str, Deque[Tuple[float, float, float]]] = {}
        self._burns: Dict[str, Dict[str, Optional[float]]] = {}
        self._listeners: List[Callable[["SloMonitor"], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = registry if registry is not None else get_global_registry()
        self._burn_gauge = reg.gauge(
            "keystone_slo_burn_rate",
            "error-budget burn rate per SLO and window (1.0 consumes "
            "the budget exactly at the sustainable rate)",
            ("slo", "window"),
        )
        _monitors.add(self)

    # -- registration ------------------------------------------------------

    def add(self, slo: Slo) -> Slo:
        with self._lock:
            if slo.name in self._slos:
                raise ValueError(f"SLO {slo.name!r} already registered")
            self._slos[slo.name] = slo
            self._samples[slo.name] = deque()
            self._burns[slo.name] = {"fast": None, "slow": None}
        return slo

    def add_listener(self, fn: Callable[["SloMonitor"], None]) -> None:
        """``fn(monitor)`` fires after every sample (watchdogs hook
        admission tightening here)."""
        self._listeners.append(fn)

    @property
    def slos(self) -> List[Slo]:
        with self._lock:
            return list(self._slos.values())

    # -- evaluation --------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> None:
        """Read every SLO's cumulative counts, append to the history,
        recompute burns, publish gauges, fire listeners."""
        now = time.monotonic() if now is None else now
        with self._lock:
            slos = list(self._slos.values())
        for slo in slos:
            try:
                total, bad = slo.read()
            except Exception:
                logger.exception("SLO %s read failed", slo.name)
                continue
            with self._lock:
                series = self._samples[slo.name]
                series.append((now, float(total), float(bad)))
                # keep one sample older than the slow window so the
                # slow delta always has a baseline to subtract from
                horizon = now - self.slow_window_s
                while len(series) > 2 and series[1][0] <= horizon:
                    series.popleft()
                self._burns[slo.name] = {
                    "fast": self._burn_locked(
                        slo, series, now, self.fast_window_s
                    ),
                    "slow": self._burn_locked(
                        slo, series, now, self.slow_window_s
                    ),
                }
                burns = self._burns[slo.name]
            for window, burn in burns.items():
                if burn is not None:
                    self._burn_gauge.set(burn, (slo.name, window))
        for fn in list(self._listeners):
            try:
                fn(self)
            except Exception:
                logger.exception("SLO listener failed")

    @staticmethod
    def _window_base(
        series: Deque[Tuple[float, float, float]],
        now: float,
        window_s: float,
    ) -> Optional[Tuple[float, float, float]]:
        """The newest sample at least ``window_s`` old — the delta
        baseline. Oldest sample when history is shorter than the window
        (a young process burns against what it has measured)."""
        base = None
        for t, total, bad in series:
            if t <= now - window_s:
                base = (t, total, bad)
            else:
                break
        if base is None and series:
            base = series[0]
        return base

    def _burn_locked(
        self,
        slo: Slo,
        series: Deque[Tuple[float, float, float]],
        now: float,
        window_s: float,
    ) -> Optional[float]:
        if len(series) < 2:
            return None
        base = self._window_base(series, now, window_s)
        latest = series[-1]
        if base is None or latest[0] <= base[0]:
            return None
        d_total = latest[1] - base[1]
        if d_total <= 0:
            return 0.0  # no traffic in the window: nothing burned
        d_bad = max(0.0, latest[2] - base[2])
        return (d_bad / d_total) / slo.budget

    def burn_rates(self, name: str) -> Dict[str, Optional[float]]:
        """The latest ``{"fast": ..., "slow": ...}`` burns for one SLO
        (None until two samples exist)."""
        with self._lock:
            return dict(self._burns.get(name) or {"fast": None, "slow": None})

    def breaching(self, name: str, burn_threshold: float = 1.0) -> bool:
        """Multiwindow page condition: BOTH windows burning past the
        threshold — fast says "now", slow says "and it's sustained"."""
        burns = self.burn_rates(name)
        return all(
            b is not None and b >= burn_threshold for b in burns.values()
        )

    def status(self) -> Dict:
        """The ``/slz`` JSON fragment for this monitor."""
        out = []
        with self._lock:
            items = list(self._slos.values())
        for slo in items:
            burns = self.burn_rates(slo.name)
            with self._lock:
                series = self._samples.get(slo.name) or ()
                latest = series[-1] if series else None
            out.append(
                {
                    "name": slo.name,
                    "description": slo.description,
                    "target": slo.target,
                    "threshold_s": slo.threshold_s,
                    "windows_s": {
                        "fast": self.fast_window_s,
                        "slow": self.slow_window_s,
                    },
                    "burn_rate": burns,
                    "breaching": self.breaching(slo.name),
                    "total": latest[1] if latest else 0.0,
                    "bad": latest[2] if latest else 0.0,
                }
            )
        return {"slos": out}

    # -- lifecycle ---------------------------------------------------------

    def start(self, interval_s: float = 5.0) -> "SloMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.sample()
                except Exception:
                    logger.exception("SLO sample failed")

        self._thread = threading.Thread(
            target=loop, name="keystone-slo-monitor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


__all__ = [
    "FAST_WINDOW_S",
    "SLOW_WINDOW_S",
    "Slo",
    "SloMonitor",
    "monitors",
    "slz_status",
]
