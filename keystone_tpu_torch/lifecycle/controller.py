"""LifecycleController: one model's refit → shadow → canary → swap
loop, wired to a live Gateway (counterpart of
``keystone_tpu/lifecycle/controller.py``).

The controller owns the SIDE EFFECTS around the pure policy
(``policy.tick``): it drains the feedback buffer into the
``RefitAccumulator``, solves candidates, builds their engines
(``Gateway.build_model_batcher`` — same serving config as the lanes,
one CUDA graph per bucket captured at build), arms/clears the pool's
shadow mirror and canary router, and drives ``Gateway.swap_model`` on
promotion and rollback. One ``tick()`` = one policy decision plus its
effects; ticks run manually (``POST /lifecyclez {"tick": true}``,
tests) or on the background interval thread (``interval_s``).

Versioned AOT store: candidate v builds against the namespace
``<aot_namespace>/v<version>`` of the process-configured store
(``serving/aot.namespaced_store``; none when no store is configured),
so a candidate never fills the incumbent's entries, and a promotion or
rollback swaps the store with the model. A closed candidate releases its engine's graphs and pools, and a swap
retires the engines it displaced (``CompiledPipeline.retire``), so the
memory the graphs hold does not grow with the versions walked through.

Rollback restores THREE things: the pool hooks (cleared), the refit
state (``restore`` to the last-good snapshot, so a poisoned
accumulation window can't leak into the next candidate), and — for a
post-promotion rollback — the serving engines themselves
(``swap_model`` back to the retained incumbent, whose graphs are
recaptured from the identical fitted pipeline).
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from keystone_tpu_torch.lifecycle.metrics import LifecycleMetrics
from keystone_tpu_torch.lifecycle.policy import (
    GateInputs,
    PolicyState,
    PromotionConfig,
    tick as policy_tick,
)
from keystone_tpu_torch.lifecycle.refit import RefitAccumulator
from keystone_tpu_torch.lifecycle.routes import CanaryRouter, ShadowMirror
from keystone_tpu_torch.observability.tracing import get_tracer

logger = logging.getLogger(__name__)


class LifecycleController:
    """Drive one model's online lifecycle over its serving gateway."""

    def __init__(
        self,
        gateway,
        *,
        base,
        head_builder: Callable[[Any, Any], Any],
        feature_dim: int,
        out_dim: int,
        name: str = "default",
        config: PromotionConfig = PromotionConfig(),
        canary_fraction: float = 0.25,
        min_refit_samples: int = 64,
        interval_s: Optional[float] = None,
        registry=None,
        aot_namespace: Optional[str] = None,
        refit_lam: float = 1e-3,
        refit_chunk: int = 64,
        holdout_every: int = 8,
        holdout_cap: int = 512,
    ):
        self._gateway = gateway
        self._aot_namespace = aot_namespace or name
        self._base = base
        self._head_builder = head_builder
        self.name = name
        self._config = config
        self._canary_fraction = float(canary_fraction)
        self._min_refit_samples = int(min_refit_samples)
        self._metrics = LifecycleMetrics(registry=registry, model=name)
        self._refit = RefitAccumulator(
            base,
            feature_dim,
            out_dim,
            name=name,
            lam=refit_lam,
            chunk=refit_chunk,
            holdout_every=holdout_every,
            holdout_cap=holdout_cap,
            metrics=self._metrics,
            device=gateway.device,
        )
        # ticks serialize here; everything below it is tick-owned
        # state, mutated only with the lock held
        self._tick_lock = threading.RLock()
        self._state = PolicyState("idle")  # guarded-by: _tick_lock
        self._version = 0  # guarded-by: _tick_lock
        self._incumbent = gateway.fitted  # guarded-by: _tick_lock
        self._previous = None  # guarded-by: _tick_lock
        self._previous_store = None  # guarded-by: _tick_lock
        self._candidate = None  # guarded-by: _tick_lock
        self._candidate_store = None  # guarded-by: _tick_lock
        self._candidate_batcher = None  # guarded-by: _tick_lock
        self._mirror: Optional[ShadowMirror] = None  # guarded-by: _tick_lock
        self._canary: Optional[CanaryRouter] = None  # guarded-by: _tick_lock
        self._last_reason = "idle"  # guarded-by: _tick_lock
        self._last_inputs = GateInputs()  # guarded-by: _tick_lock
        self._solved_at_n = 0  # guarded-by: _tick_lock
        self._last_good = self._refit.snapshot()  # guarded-by: _tick_lock
        # feedback lands here (HTTP handler threads) and drains into
        # the accumulator at tick time
        self._fb_lock = threading.Lock()
        self._fb: list = []  # guarded-by: _fb_lock
        self._closed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if interval_s:
            self._thread = threading.Thread(
                target=self._loop,
                args=(float(interval_s),),
                name=f"keystone-lifecycle-{name}",
                daemon=True,
            )
            self._thread.start()

    # -- feedback intake ---------------------------------------------------

    def add_feedback(self, instances: Any, labels: Any) -> int:
        """Queue one labeled batch (``POST /feedback`` lands here).
        Validation is shape-only and cheap — the accumulation happens
        at tick time, off the request path."""
        X = np.asarray(instances, np.float32)
        Y = np.asarray(labels, np.float32)
        if X.ndim != 2 or Y.ndim != 2 or X.shape[0] != Y.shape[0]:
            raise ValueError(
                f"need matching 2-D instances/labels, got "
                f"{X.shape} vs {Y.shape}"
            )
        with self._fb_lock:
            if self._closed:
                raise RuntimeError("lifecycle controller is closed")
            self._fb.append((X, Y))
        return int(X.shape[0])

    def _drain_feedback(self) -> int:
        with self._fb_lock:
            batches, self._fb = self._fb, []
        folded = 0
        if batches:
            with get_tracer().span(
                "lifecycle.refit", model=self.name,
                batches=len(batches),
            ):
                for X, Y in batches:
                    folded += self._refit.add(X, Y)
        return folded

    # -- the tick ----------------------------------------------------------

    def tick(self) -> Dict:
        """Drain feedback, maybe solve a new candidate, take one
        policy decision, apply its side effects. Returns ``status()``."""
        with self._tick_lock:
            if self._closed:
                return self.status()
            with get_tracer().span("lifecycle.tick", model=self.name):
                self._drain_feedback()
                if self._state.stage in ("idle", "promoted",
                                         "rolled_back"):
                    fresh = (self._refit.n_accumulated
                             - self._solved_at_n)
                    if fresh >= self._min_refit_samples:
                        self._start_candidate_locked()
                    else:
                        return self.status()
                inputs = self._gate_inputs()
                new_state, reason = policy_tick(
                    self._state, inputs, self._config
                )
                if new_state.stage != self._state.stage:
                    self._apply_transition_locked(new_state.stage, reason)
                self._state = new_state
                self._last_reason = reason
                self._last_inputs = inputs
                self._metrics.set_stage(new_state.stage)
            return self.status()

    def _start_candidate_locked(self) -> None:
        from keystone_tpu_torch.serving.aot import namespaced_store

        W, b = self._refit.solve()
        self._version += 1
        self._candidate = self._base.and_then(self._head_builder(W, b))
        self._candidate_store = namespaced_store(f"{self._aot_namespace}/v{self._version}")
        self._candidate_batcher = self._gateway.build_model_batcher(
            self._candidate,
            name=f"{self.name}-cand-v{self._version}",
            aot_store=self._candidate_store,
        )
        self._solved_at_n = self._refit.n_accumulated
        self._state = PolicyState("candidate")
        self._metrics.set_version(self._version)
        logger.info(
            "lifecycle %s: candidate v%d solved from %d samples",
            self.name, self._version, self._solved_at_n,
        )

    def _gate_inputs(self) -> GateInputs:
        shadow = self._mirror.stats() if self._mirror else {}
        canary = self._canary.stats() if self._canary else {}
        slo = self._gateway.slo_status()
        cand_err = inc_err = None
        if self._candidate is not None:
            cand_err, inc_err = self._refit.holdout_errors(
                self._candidate, self._incumbent
            )
        return GateInputs(
            shadow_pairs=shadow.get("pairs", 0),
            shadow_max_abs=shadow.get("max_abs", 0.0),
            canary_requests=canary.get("requests", 0),
            canary_errors=canary.get("errors", 0),
            slo_breaching=bool(slo and slo.get("breaching")),
            candidate_err=cand_err,
            incumbent_err=inc_err,
        )

    def _apply_transition_locked(self, stage: str, reason: str) -> None:
        pool = self._gateway.pool
        if stage == "shadow":
            self._mirror = ShadowMirror(
                self._candidate_batcher,
                model=self.name,
                metrics=self._metrics,
            )
            pool.set_mirror(self._mirror)
        elif stage == "canary":
            pool.set_mirror(None)
            self._canary = CanaryRouter(
                self._candidate_batcher,
                self._canary_fraction,
                model=self.name,
                metrics=self._metrics,
            )
            pool.set_canary(self._canary)
        elif stage == "promoted":
            pool.set_canary(None)
            pool.set_mirror(None)
            prev_store = getattr(self._gateway, "_aot_store", None)
            ok = self._gateway.swap_model(self._candidate, aot_store=self._candidate_store)
            if not ok:  # close() won the race; nothing rotated
                self._close_candidate_locked()
                return
            self._previous = self._incumbent
            self._previous_store = prev_store
            self._incumbent = self._candidate
            self._last_good = self._refit.snapshot()
            self._metrics.record_promotion()
            self._close_candidate_locked()
            logger.info(
                "lifecycle %s: v%d PROMOTED", self.name, self._version
            )
        elif stage == "rolled_back":
            self._rollback_effects_locked(reason)

    def _rollback_effects_locked(self, reason: str) -> None:
        pool = self._gateway.pool
        pool.set_canary(None)
        pool.set_mirror(None)
        # discard the tainted accumulation window: everything since
        # the last KNOWN-GOOD state (initial, or the last promotion)
        # — a poisoned chunk must not leak into the next candidate
        self._refit.restore(self._last_good)
        self._solved_at_n = self._refit.n_accumulated
        self._close_candidate_locked()
        self._metrics.record_rollback(reason)
        logger.warning(
            "lifecycle %s: v%d ROLLED BACK (%s)",
            self.name, self._version, reason,
        )

    def force_rollback(self, reason: str = "manual") -> Dict:
        """Operator rollback. Mid-cycle it kills the candidate (same
        path as a policy rollback); after a promotion — with no new
        cycle active — it swaps the serving engines back to the
        retained pre-promotion incumbent."""
        with self._tick_lock:
            stage = self._state.stage
            if stage in ("candidate", "shadow", "canary"):
                self._rollback_effects_locked(reason)
                self._state = PolicyState("rolled_back")
            elif self._previous is not None:
                ok = self._gateway.swap_model(self._previous, aot_store=self._previous_store)
                if ok:
                    self._incumbent = self._previous
                    self._previous = None
                    self._state = PolicyState("rolled_back")
                    self._metrics.record_rollback(reason)
                    logger.warning(
                        "lifecycle %s: promotion v%d un-promoted (%s)",
                        self.name, self._version, reason,
                    )
            self._last_reason = reason
            self._metrics.set_stage(self._state.stage)
            return self.status()

    def _close_candidate_locked(self) -> None:
        batcher, self._candidate_batcher = self._candidate_batcher, None
        if batcher is not None:
            try:
                batcher.close(timeout=5.0)
                # drained: its graphs and their pools go now
                batcher.engine.retire()
            except Exception:
                logger.exception(
                    "lifecycle %s: candidate batcher close failed",
                    self.name,
                )

    # -- inspection / plumbing ---------------------------------------------

    def status(self) -> Dict:
        """The ``/lifecyclez`` document for this model."""
        with self._fb_lock:
            pending = sum(x.shape[0] for x, _ in self._fb)
        inputs = self._last_inputs
        return {
            "model": self.name,
            "state": self._state.stage,
            "version": self._version,
            "last_reason": self._last_reason,
            "refit": {
                "accumulated": self._refit.n_accumulated,
                "holdout": self._refit.n_holdout,
                "pending": pending,
                "min_refit_samples": self._min_refit_samples,
            },
            "shadow": self._mirror.stats() if self._mirror else None,
            "canary": self._canary.stats() if self._canary else None,
            "errors": {
                "candidate": inputs.candidate_err,
                "incumbent": inputs.incumbent_err,
            },
            "promotions": int(self._metrics.promotion_count()),
        }

    def _loop(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            try:
                self.tick()
            except Exception:
                logger.exception(
                    "lifecycle %s: tick failed", self.name
                )

    def close(self, timeout: float = 10.0) -> None:
        with self._fb_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        with self._tick_lock:
            pool = self._gateway.pool
            pool.set_canary(None)
            pool.set_mirror(None)
            self._close_candidate_locked()

    def __enter__(self) -> "LifecycleController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["LifecycleController"]
