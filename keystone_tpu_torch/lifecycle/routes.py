"""Shadow mirror + canary router: how a candidate engine meets live
traffic (counterpart of ``keystone_tpu/lifecycle/routes.py``).

Both objects wrap the candidate's OWN ``MicroBatcher`` (built by
``Gateway.build_model_batcher`` — same buckets/featurize config as
the serving lanes, its own CUDA-graph engine) and plug into the
``EnginePool`` hooks (``pool.set_mirror`` / ``pool.set_canary``):

- ``ShadowMirror.observe(example, primary_future)`` — called once per
  pool submit, OFF the response path: the example is copied to the
  candidate batcher and the (primary, shadow) outputs are diffed in
  completion callbacks. The primary future is never touched beyond a
  read; a candidate that errors, stalls, or is saturated costs served
  traffic nothing (bounded in-flight, drop-newest).
- ``CanaryRouter`` — ``takes()`` is the DETERMINISTIC per-request
  fraction (``pool.canary_takes`` over a process-local sequence:
  exactly ``floor(n·f)`` of every ``n`` requests, no RNG), and
  ``route`` submits the taken request to the candidate ON the
  response path — but a candidate failure falls back to the incumbent
  lanes through the pool's normal submit path, so a broken candidate
  feeds the policy's error-rate gate without ever failing a caller.
"""

from __future__ import annotations

import itertools
import logging
import threading
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from keystone_tpu_torch.gateway.pool import canary_takes

logger = logging.getLogger(__name__)


class ShadowMirror:
    """Mirror live traffic onto a candidate batcher and keep rolling
    output-diff stats."""

    def __init__(
        self,
        batcher,
        *,
        model: str = "default",
        metrics=None,  # LifecycleMetrics; duck-typed
        max_inflight: int = 64,
    ):
        self._batcher = batcher
        self.model = model
        self._metrics = metrics
        self._max_inflight = int(max_inflight)
        self._lock = threading.Lock()
        self._inflight = 0  # guarded-by: _lock
        self._pairs = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._errors = 0  # guarded-by: _lock
        self._mean_abs = 0.0  # guarded-by: _lock
        self._max_abs = 0.0  # guarded-by: _lock

    def observe(self, example: Any, primary: Future) -> None:
        """Fire-and-forget mirror of one live request. Never raises —
        the pool calls this on its submit path."""
        try:
            with self._lock:
                if self._inflight >= self._max_inflight:
                    self._dropped += 1
                    return
                self._inflight += 1
            shadow = self._batcher.submit(example)
        except Exception:
            with self._lock:
                self._inflight -= 1
                self._errors += 1
            return
        shadow.add_done_callback(
            lambda f: self._pair(primary, f)
        )

    def _pair(self, primary: Future, shadow: Future) -> None:
        # runs on the candidate batcher's delivery thread, after the
        # primary usually already resolved; a still-pending primary
        # chains one more callback instead of blocking this thread
        with self._lock:
            self._inflight -= 1
        if shadow.exception() is not None:
            with self._lock:
                self._errors += 1
            return
        if not primary.done():
            primary.add_done_callback(
                lambda f: self._diff(f, shadow)
            )
            return
        self._diff(primary, shadow)

    def _diff(self, primary: Future, shadow: Future) -> None:
        try:
            if primary.exception() is not None:
                return
            diff = np.abs(
                np.asarray(primary.result(), np.float32)
                - np.asarray(shadow.result(), np.float32)
            )
            mean_abs, max_abs = float(diff.mean()), float(diff.max())
        except Exception:
            with self._lock:
                self._errors += 1
            return
        with self._lock:
            self._pairs += 1
            # rolling mean of means; max is a running max
            self._mean_abs += (mean_abs - self._mean_abs) / self._pairs
            self._max_abs = max(self._max_abs, max_abs)
            stats = (self._mean_abs, self._max_abs)
        if self._metrics is not None:
            self._metrics.record_shadow_pair(*stats)

    def stats(self) -> dict:
        with self._lock:
            return {
                "pairs": self._pairs,
                "mean_abs": round(self._mean_abs, 6),
                "max_abs": round(self._max_abs, 6),
                "errors": self._errors,
                "dropped": self._dropped,
            }


class CanaryRouter:
    """Route a deterministic fraction of live traffic to the
    candidate, with incumbent fallback on any candidate failure."""

    def __init__(
        self,
        batcher,
        fraction: float,
        *,
        model: str = "default",
        metrics=None,  # LifecycleMetrics; duck-typed
    ):
        if not (0.0 <= fraction <= 1.0):
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        self._batcher = batcher
        self.fraction = float(fraction)
        self.model = model
        self._metrics = metrics
        self._seq = itertools.count()  # CPython-atomic next()
        self._lock = threading.Lock()
        self._requests = 0  # guarded-by: _lock
        self._errors = 0  # guarded-by: _lock

    def takes(self) -> bool:
        """The per-request canary decision — deterministic, not
        sampled: over any window of n requests exactly
        ``floor(n·fraction)`` (±1) land on the candidate."""
        return canary_takes(next(self._seq), self.fraction)

    def route(
        self,
        example: Any,
        parent_span_id,
        out: Future,
        fallback: Callable[[], None],
    ) -> None:
        """Serve one taken request from the candidate; any failure
        (submit-time or dispatch) re-routes through ``fallback`` (the
        pool's normal incumbent path) so the caller never sees a
        candidate error — the policy's error-rate gate does."""
        with self._lock:
            self._requests += 1
        try:
            fut = self._batcher.submit(example, parent_span_id=parent_span_id)
        except Exception:
            self._record_error()
            fallback()
            return

        def done(f: Future) -> None:
            if f.exception() is not None:
                self._record_error()
                fallback()
                return
            if self._metrics is not None:
                self._metrics.record_canary("ok")
            out.canary = True
            try:
                out.set_result(f.result())
            except Exception:
                pass  # caller cancelled concurrently

        fut.add_done_callback(done)

    def _record_error(self) -> None:
        with self._lock:
            self._errors += 1
        if self._metrics is not None:
            self._metrics.record_canary("error")

    def stats(self) -> dict:
        with self._lock:
            return {
                "fraction": self.fraction,
                "requests": self._requests,
                "errors": self._errors,
            }


__all__ = ["ShadowMirror", "CanaryRouter"]
