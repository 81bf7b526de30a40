"""Thread-safe counters and latency reservoirs (counterpart of
``keystone_tpu/utils/profiling.py``: ``Counter``, ``LatencyRecorder`` and
``_interp_percentile``, copied as they are).

The JAX module's ``trace`` wraps the JAX profiler; the port goes without
it: ``torch.profiler.profile`` is the device trace here, and
``chip_smoke.py`` opens it where it profiles a dispatch.
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, Dict, Optional


def _interp_percentile(data, p: float) -> Optional[float]:
    """Linear-interpolated percentile of ascending ``data`` (p in
    [0, 100]); the ONE implementation ``percentile()`` and
    ``snapshot()`` share so exporters can never disagree."""
    if not data:
        return None
    rank = (p / 100.0) * (len(data) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(data) - 1)
    frac = rank - lo
    return data[lo] * (1.0 - frac) + data[hi] * frac


class LatencyRecorder:
    """Thread-safe latency reservoir with percentile queries.

    Serving code records one sample per dispatch/request; the reservoir
    keeps the most recent ``window`` samples (steady-state behaviour,
    not startup transients) while count/total accumulate forever so
    rates stay exact. Percentiles sort a bounded copy — cheap at the
    default window, and never taken on the dispatch hot path.
    """

    def __init__(self, window: int = 4096):
        self._samples: Deque[float] = collections.deque(maxlen=window)
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)
            self.count += 1
            self.total += seconds

    def percentile(self, p: float) -> Optional[float]:
        """p in [0, 100]; None until a sample exists."""
        with self._lock:
            data = sorted(self._samples)
        return _interp_percentile(data, p)

    @property
    def p50(self) -> Optional[float]:
        return self.percentile(50.0)

    @property
    def p95(self) -> Optional[float]:
        return self.percentile(95.0)

    @property
    def p99(self) -> Optional[float]:
        return self.percentile(99.0)

    @property
    def mean(self) -> Optional[float]:
        with self._lock:
            return self.total / self.count if self.count else None

    def snapshot(self) -> Dict[str, Optional[float]]:
        """count/total/p50/p95/p99 under ONE lock acquisition — a
        mutually consistent view (separate property reads can straddle
        concurrent records; exporters and ``ServingMetrics.summary()``
        use this)."""
        with self._lock:
            count = self.count
            total = self.total
            data = sorted(self._samples)
        return {
            "count": count,
            "total": total,
            "p50": _interp_percentile(data, 50.0),
            "p95": _interp_percentile(data, 95.0),
            "p99": _interp_percentile(data, 99.0),
        }


class Counter:
    """Thread-safe monotonically increasing counter with labeled cells
    (e.g. one cell per bucket size)."""

    def __init__(self):
        self._cells: Dict = collections.defaultdict(int)
        self._lock = threading.Lock()

    def inc(self, label=None, by: int = 1) -> None:
        with self._lock:
            self._cells[label] += by

    def get(self, label=None) -> int:
        with self._lock:
            return self._cells.get(label, 0)

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self._cells.values())

    def snapshot(self) -> Dict:
        with self._lock:
            return dict(self._cells)
