"""Tracing and profiling utilities (counterpart of
``keystone_tpu/utils/profiling.py``: ``Counter``, ``LatencyRecorder``,
``PhaseTimer`` and ``_interp_percentile`` copied as they are).

- ``trace(dir)``: a ``torch.profiler`` trace (host, and the card's kernels
  where there is one) around a block of pipeline work, written to ``dir``
  as a Chrome trace; the JAX module's wraps the JAX profiler.
- ``instrument_executor``: per-node wall time through a GraphExecutor's
  ``node_hook`` (the interpret-layer profile).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
from typing import Deque, Dict, Iterator, Optional

logger = logging.getLogger(__name__)


_device_ready = False
_device_ready_lock = threading.Lock()


def ready_device_tracing() -> None:
    """Open and close one throwaway ``torch.profiler`` session on the
    card, once per process. A gateway calls it before it builds its
    lanes: on an H100, device traces of a process whose lanes were built
    before its first profiler session held none of the lanes' activity,
    while with this session first they do. (A plain thread replaying a
    graph made before the first session is traced either way; what in
    the lanes' set-up hides them is not known.)"""
    global _device_ready
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _device_ready_lock:
        if _device_ready:
            return
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            # lint: disable=blocking-under-lock
            # once per process, before the lanes: a second caller must
            # wait for this profile to end; no request takes the lock
            torch.cuda.synchronize()
        _device_ready = True


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace around a block of pipeline work: host activity,
    and the card's kernels where CUDA is available, of every thread of the
    process (as the JAX profiler traces the whole process: a serving
    lane's replays run on its own threads), exported as a Chrome trace
    (``trace_<pid>_<ns>.json``, viewable in Perfetto or chrome://tracing)
    into ``log_dir``, which is made if missing."""
    import torch
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )


class PhaseTimer:
    """Accumulates named phase wall-clock times (reference: the
    kernelGen/residual/collect/localSolve/modelUpdate logs in KRR)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.times: Dict[str, float] = {}
        self._published: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, phase_name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.times[phase_name] = self.times.get(phase_name, 0.0) + dt

    def summary(self) -> str:
        parts = [f"{k}: {v:.3f}s" for k, v in self.times.items()]
        prefix = f"{self.name} " if self.name else ""
        return prefix + " ".join(parts)

    def log(self) -> None:
        logger.info(self.summary())

    def publish(self, registry=None) -> None:
        """Publish accumulated phase times into a ``MetricsRegistry``
        (the global one by default) as
        ``keystone_phase_seconds_total{timer=..., phase=...}``. Publishes
        only the delta since the last publish, so periodic calls from a
        long fit never double-count."""
        from keystone_tpu_torch.observability.registry import get_global_registry

        reg = registry if registry is not None else get_global_registry()
        counter = reg.counter(
            "keystone_phase_seconds_total",
            "accumulated wall seconds per named phase",
            labelnames=("timer", "phase"),
        )
        for phase_name, seconds in self.times.items():
            delta = seconds - self._published.get(phase_name, 0.0)
            if delta > 0:
                counter.inc((self.name or "phase_timer", phase_name), delta)
                self._published[phase_name] = seconds


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


def instrument_executor(executor) -> Dict:
    """Record per-node wall time on a GraphExecutor via its ``node_hook``
    (workflow/executor.py). Returns the (live) dict of node -> seconds,
    accumulated as nodes execute."""
    times: Dict = {}

    def hook(graph_id, label, seconds):
        times[graph_id] = times.get(graph_id, 0.0) + seconds

    executor.node_hook = hook
    return times
