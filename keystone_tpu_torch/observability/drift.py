"""Workload drift detection: live request histograms vs the plan's
(counterpart of ``keystone_tpu/observability/drift.py``, copied as it
is).

The placement planner (``zoo/optimizer.py``) chooses buckets, lanes,
and sharding from a request-size histogram per model — and then the
plan flies blind: traffic whose size mixture shifts after planning
quietly pays padding waste (or chunking) the plan was built to avoid.
The ``DriftDetector`` watches for exactly that: each model's live
request sizes are kept as a trailing-window event deque (windowed
deltas, so yesterday's traffic can't mask today's shift), the plan's
assumed ``ModelProfile`` histogram is the pinned baseline, and the
distance between them is the **population stability index**:

    ``PSI = sum_i (live_i - base_i) * ln(live_i / base_i)``

over the union of size bins, with both fractions clipped to a small
epsilon so bins present on one side only contribute finitely. PSI is
symmetric-ish, zero for identical mixtures, and the industry folklore
thresholds apply: < 0.1 stable, 0.1-0.25 moderate, > 0.25 shifted —
the default trip threshold here.

Crossing the threshold does three things, none of them auto-apply:
``keystone_drift_score{model}`` (a gauge, federated by MAX across the
fleet — the worst replica's drift is the fleet's drift), a flight-
recorder capture (reason ``drift``) so the moment of the shift keeps
its forensics, and the ``/driftz`` audit: the zoo re-runs
``plan_placement`` on the LIVE profiles and publishes the diff of what
*would* change (``zoo/optimizer.diff_plans``) as a recommendation.
Applying it stays an operator decision (ROADMAP follow-on).

Scores are absent-not-zero: a model scores only once it has a baseline
AND ``min_rows`` live observations in the window — a cold model is
unknown, not stable.
"""

from __future__ import annotations

import collections
import math
import threading
import time
import weakref
from typing import Deque, Dict, List, Mapping, Optional, Tuple

# PSI folklore: > 0.25 = the population has shifted
DEFAULT_THRESHOLD = 0.25
# live observations required before a score is emitted at all
DEFAULT_MIN_ROWS = 32
# trailing window of live request sizes
DEFAULT_WINDOW_S = 120.0
# fraction floor for one-sided bins (a bin seen live but never in the
# baseline must contribute a large-but-finite surprise, not infinity)
PSI_EPS = 1e-4


def psi(
    baseline: Mapping[int, float],
    live: Mapping[int, float],
    eps: float = PSI_EPS,
) -> Optional[float]:
    """Population stability index between two size histograms (raw
    counts or weights; normalized here). None when either side is
    empty — no distribution, no distance."""
    base_total = sum(baseline.values())
    live_total = sum(live.values())
    if base_total <= 0 or live_total <= 0:
        return None
    score = 0.0
    for size in set(baseline) | set(live):
        b = max(baseline.get(size, 0.0) / base_total, eps)
        l = max(live.get(size, 0.0) / live_total, eps)
        score += (l - b) * math.log(l / b)
    return score


class DriftDetector:
    """Per-model live-histogram drift against pinned plan baselines."""

    def __init__(
        self,
        *,
        threshold: float = DEFAULT_THRESHOLD,
        min_rows: int = DEFAULT_MIN_ROWS,
        window_s: float = DEFAULT_WINDOW_S,
        clock=time.monotonic,
        flight=None,
    ):
        self.threshold = float(threshold)
        self.min_rows = int(min_rows)
        self.window_s = float(window_s)
        self._clock = clock
        # flight recorder (observability/flight.py) for drift captures;
        # weakly held so the detector never extends a gateway's life
        self._flight = weakref.ref(flight) if flight is not None else None
        self._lock = threading.Lock()
        self._baselines: Dict[str, Dict[int, float]] = {}
        self._events: Dict[str, Deque[Tuple[float, int]]] = {}
        # models currently over threshold — capture fires on the
        # TRANSITION into drift, not on every scrape while drifted
        self._flagged: set = set()

    # -- inputs ------------------------------------------------------------

    def set_baseline(
        self, model: str, histogram: Mapping[int, float]
    ) -> None:
        """Pin the plan-assumed size histogram for one model (what the
        applied ``ModelProfile`` carried). An empty histogram clears —
        the model stops scoring rather than scoring against nothing."""
        hist = {
            int(s): float(c) for s, c in (histogram or {}).items() if c > 0
        }
        with self._lock:
            if hist:
                self._baselines[model] = hist
            else:
                self._baselines.pop(model, None)
                self._flagged.discard(model)

    def observe(self, model: str, size: int) -> None:
        """One live request of ``size`` rows for ``model``."""
        now = self._clock()
        cutoff = now - self.window_s
        with self._lock:
            events = self._events.get(model)
            if events is None:
                events = self._events[model] = collections.deque()
            events.append((now, int(size)))
            while events and events[0][0] < cutoff:
                events.popleft()

    # -- queries -----------------------------------------------------------

    def baselines(self) -> Dict[str, Dict[int, float]]:
        with self._lock:
            return {m: dict(h) for m, h in self._baselines.items()}

    def live_histogram(self, model: str) -> Dict[int, int]:
        """The trailing-window request-size histogram for one model."""
        now = self._clock()
        cutoff = now - self.window_s
        with self._lock:
            events = self._events.get(model, ())
            hist: Dict[int, int] = {}
            for t, size in events:
                if t >= cutoff:
                    hist[size] = hist.get(size, 0) + 1
        return hist

    def live_histograms(self) -> Dict[str, Dict[int, int]]:
        with self._lock:
            models = list(self._events)
        return {m: self.live_histogram(m) for m in models}

    def scores(self) -> Dict[str, float]:
        """PSI per model — only models with a baseline and at least
        ``min_rows`` windowed observations (absent, never zero)."""
        baselines = self.baselines()
        out: Dict[str, float] = {}
        for model, base in baselines.items():
            live = self.live_histogram(model)
            if sum(live.values()) < self.min_rows:
                continue
            score = psi(base, live)
            if score is not None:
                out[model] = score
        self._update_flags(out)
        return out

    def drifted(self) -> List[str]:
        """Models whose current score exceeds the threshold."""
        return sorted(
            m for m, s in self.scores().items() if s > self.threshold
        )

    def _update_flags(self, scores: Dict[str, float]) -> None:
        """Track threshold transitions; capture each model's ENTRY into
        drift in the flight recorder (reason ``drift``) so the moment
        keeps its forensics."""
        newly = []
        with self._lock:
            for model, score in scores.items():
                over = score > self.threshold
                if over and model not in self._flagged:
                    self._flagged.add(model)
                    newly.append((model, score))
                elif not over:
                    self._flagged.discard(model)
        if not newly:
            return
        flight = self._flight() if self._flight is not None else None
        if flight is None:
            # no recorder injected: capture into the process's live one
            # (the gateway's), when any exists — same weak posture as
            # /debugz, which browses the module-level recorder set
            from keystone_tpu_torch.observability import flight as flight_mod

            live = flight_mod.recorders()
            flight = live[0] if live else None
        if flight is None:
            return
        for model, score in newly:
            try:
                flight.capture(
                    None, "drift",
                    model=model,
                    psi=round(score, 4),
                    threshold=self.threshold,
                )
            except Exception:  # forensics must never take down serving
                pass

    # -- MetricsRegistry bridge --------------------------------------------

    def register(self, registry=None) -> None:
        """Export ``keystone_drift_score{model}`` — a gauge that
        federates by MAX (``prometheus.MERGE_MAX_FAMILIES``): the worst
        replica's drift is the fleet's drift; two replicas each at 0.3
        are not a fleet at 0.6."""
        from keystone_tpu_torch.observability.registry import get_global_registry

        reg = registry if registry is not None else get_global_registry()
        ref = weakref.ref(self)

        def read():
            det = ref()
            if det is None:
                return {}
            return {(m,): s for m, s in det.scores().items()}

        reg.gauge_func(
            "keystone_drift_score", read,
            "population stability index of the model's live windowed "
            "request-size histogram vs the applied plan's baseline "
            "(> threshold = the plan no longer matches the traffic)",
            ("model",),
        )

    def document(self) -> Dict:
        """The detector-level half of ``/driftz`` (the zoo wraps this
        with the re-plan recommendation)."""
        scores = self.scores()
        return {
            "threshold": self.threshold,
            "min_rows": self.min_rows,
            "window_s": self.window_s,
            "scores": {m: round(s, 4) for m, s in sorted(scores.items())},
            "drifted": sorted(
                m for m, s in scores.items() if s > self.threshold
            ),
            "baselines": {
                m: {str(k): v for k, v in sorted(h.items())}
                for m, h in sorted(self.baselines().items())
            },
            "live": {
                m: {str(k): v for k, v in sorted(h.items())}
                for m, h in sorted(self.live_histograms().items())
                if h
            },
        }


__all__ = [
    "DEFAULT_MIN_ROWS",
    "DEFAULT_THRESHOLD",
    "DEFAULT_WINDOW_S",
    "DriftDetector",
    "PSI_EPS",
    "psi",
]
