"""Adaptive micro-batching: coalesce single-example requests into
bucketed dispatches (counterpart of ``keystone_tpu/serving/batching.py``).

``submit()`` enqueues an example and returns a ``Future``; a dispatcher
thread coalesces everything that arrives within a max-latency deadline
(or until the largest bucket fills, whichever first) into ONE padded
bucket dispatch through a ``CompiledPipeline``, then resolves each
request's future with its own row of the result, as a numpy array.

Pending requests are segregated by example spec (tree structure +
per-leaf shape/dtype): interleaved streams with different shapes each
coalesce into their own spec-homogeneous windows, and the dispatcher
always drains the spec whose OLDEST request is closest to its deadline
first, so segregation never starves a stream.

Latency/throughput contract: a lone request waits at most ``max_delay``
before dispatching solo; under load, dispatches fill toward
``max_batch`` and per-request latency approaches the bucket's execution
time. Queue depth, coalesce sizes, and request p50/p99 are recorded on
the shared ``ServingMetrics``.

``swap_engine()`` atomically replaces the engine behind the batcher —
queued and future windows dispatch through the replacement, the window
already in flight completes on the old engine, and no request is
dropped or reordered. In pipelined mode the swap also rebuilds the lane
pipeline's host staging pool.

``pipeline_depth > 0`` turns the lane into a STAGED PIPELINE
(serving/pipeline.py): the dispatcher hands each window to per-stage
threads (host-prep → upload → compute → deliver) connected by bounded
queues, so window k+1's host work and upload overlap window k's device
compute. Results are bit-identical to the serial path — both compose the
engine's same stage primitives over identical values and replay the same
CUDA graph. ``host_featurize`` plugs an items-mode front-end into the
prep stage of EITHER mode: clients submit raw items, the hook turns each
coalesced window into the batched array tree the engine stages.

Serving with the port::

    engine = fitted_model.compiled((8, 64), featurize=feat)   # cuda
    engine.warmup(example=np.zeros((256, 256, 3), np.uint8))
    batcher = MicroBatcher(engine, pipeline_depth=2)
    top5 = batcher.submit(image).result()
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch.observability.tracing import get_tracer
from keystone_tpu_torch.serving.engine import CompiledPipeline, _row_spec
from keystone_tpu_torch.serving.pipeline import (
    HostFeaturize,
    LaneFuture,
    LanePipeline,
    resolve_window_futures,
)

logger = logging.getLogger(__name__)

# (example, future, enqueue time, optional parent span id)
_Entry = Tuple[Any, Future, float, Optional[int]]

# NON-ARRAY raw items (strings, records) coalesce into ONE stream when a
# host featurizer owns the window: the hook defines homogeneity there.
# ARRAY items still key by (shape, dtype) even in items mode, so
# mixed-size raw images bucket into per-shape windows.
_ITEMS_SPEC = ("items",)


def _lift(a: Any) -> Any:
    """One example as a ``[1, ...]`` VIEW (no copy)."""
    if isinstance(a, torch.Tensor):
        return a[None]
    return np.asarray(a)[None]


def _stack(examples: List[Any]) -> Any:
    """Stack a window of examples (trees of equal structure). Host
    payloads stack on the HOST, so the whole window then crosses to the
    device as ONE transfer inside the engine."""
    first = examples[0]
    if isinstance(first, tuple):
        return tuple(_stack([e[i] for e in examples]) for i in range(len(first)))
    if any(isinstance(x, torch.Tensor) for x in examples):
        return torch.stack([torch.as_tensor(x) for x in examples])
    return np.stack([np.asarray(x) for x in examples])


def _tree_lift(example: Any) -> Any:
    if isinstance(example, tuple):
        return tuple(_tree_lift(e) for e in example)
    return _lift(example)


class MicroBatcher:
    def __init__(
        self,
        engine: CompiledPipeline,
        max_delay_ms: float = 5.0,
        max_batch: Optional[int] = None,
        pipeline_depth: int = 0,
        host_featurize: Optional[HostFeaturize] = None,
    ):
        self.engine = engine
        self.max_delay = max_delay_ms / 1e3
        # an explicit max_batch is pinned across engine swaps; the
        # default tracks whatever the current engine's largest bucket is
        self._max_batch_pinned = max_batch is not None
        self.max_batch = max_batch or engine.max_bucket
        if self.max_batch > engine.max_bucket:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds the engine's largest "
                f"bucket {engine.max_bucket}"
            )
        self.host_featurize = host_featurize
        self.pipeline_depth = int(pipeline_depth)
        # pipeline_depth > 0: dispatch through the staged lane pipeline
        # (host-prep/upload/compute/deliver threads, bounded handoffs)
        # instead of inline — see serving/pipeline.py
        self._pipeline: Optional[LanePipeline] = (
            LanePipeline(
                self._assemble, depth=self.pipeline_depth,
                name=engine.name,
                # gauge the pool on whichever engine currently serves
                # the lane, so windows that outlive a swap don't stamp
                # the new pool's footprint onto a retired engine
                current_metrics=lambda: self.metrics,
            )
            if self.pipeline_depth > 0 else None
        )
        self.metrics = engine.metrics
        # pending requests segregated by spec: each spec coalesces into
        # its own windows, so interleaved streams of different shapes
        # never poison each other
        self._pending: dict = {}  # spec -> List[_Entry], insertion-ordered
        self._n_pending = 0
        self._cond = threading.Condition()
        # the condition every request future of this lane waits on: a
        # window resolves its futures under one hold of it
        self._futures_cond = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, name="keystone-microbatcher", daemon=True
        )
        self._worker.start()

    # -- client side -------------------------------------------------------

    def _example_spec(self, example: Any):
        if self.host_featurize is not None:
            # items mode: array items still carry a (shape, dtype)
            # identity worth segregating on; non-array items (strings,
            # records) keep the single shared stream
            if hasattr(example, "shape") and hasattr(example, "dtype"):
                return ("items",) + _row_spec(example, drop=0)
            return _ITEMS_SPEC
        return _row_spec(example, drop=0)

    def submit(
        self, example: Any, parent_span_id: Optional[int] = None
    ) -> "Future":
        """Enqueue one example (a tree WITHOUT the leading batch axis);
        the returned future resolves to that example's pipeline output.
        ``parent_span_id`` threads an upstream span through to the
        window's ``microbatch.coalesce`` span, which runs on the
        dispatcher thread."""
        spec = self._example_spec(example)
        fut: Future = LaneFuture(self._futures_cond)
        with self._cond:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._pending.setdefault(spec, []).append(
                (example, fut, time.perf_counter(), parent_span_id)
            )
            self._n_pending += 1
            self.metrics.set_queue_depth(self._n_pending)
            self._cond.notify()
        return fut

    def swap_engine(self, engine: CompiledPipeline) -> CompiledPipeline:
        """Atomically replace the engine behind this batcher and return
        the old one. Queued and future windows dispatch through the new
        engine; a window already in flight completes on the old engine.
        No request is dropped."""
        with self._cond:
            old, self.engine = self.engine, engine
            self.metrics = engine.metrics
            if not self._max_batch_pinned:
                self.max_batch = engine.max_bucket
            elif self.max_batch > engine.max_bucket:
                # engine.apply chunks oversized windows through its
                # largest bucket, so a too-small replacement degrades
                # (extra dispatches per window) instead of failing swaps
                logger.warning(
                    "swap_engine: pinned max_batch %d exceeds the new "
                    "engine's largest bucket %d; windows will chunk",
                    self.max_batch, engine.max_bucket,
                )
            if self._pipeline is not None:
                # rebuild the host staging pool: its buffers are cut
                # for the old bucket set; in-flight windows keep their
                # coalesce-time engine and finish on it
                self._pipeline.on_swap()
                # self.metrics was reassigned BEFORE the reset and these
                # stamps run AFTER it (publish_staging_bytes' contract)
                old.metrics.set_staging_bytes(0)
                engine.metrics.set_staging_bytes(
                    self._pipeline.pool.staging_bytes
                )
            self._cond.notify()
        return old

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Flush pending requests and stop the dispatcher thread. If the
        dispatcher can't drain within ``timeout`` (e.g. it is inside a
        graph capture) this logs a warning and returns — the daemon
        worker keeps resolving in-flight futures as long as the process
        lives. Futures a dead worker would strand are failed rather than
        left to hang their waiters."""
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._worker.join(timeout)
        if self._worker.is_alive():
            logger.warning(
                "MicroBatcher dispatcher still running after %.1fs "
                "close timeout (graph capture in flight?); pending "
                "futures will resolve as it finishes", timeout,
            )
            return
        if self._pipeline is not None:
            # the dispatcher has pushed every pending window into the
            # stage chain; flush it through and stop the stage threads
            self._pipeline.close(timeout=timeout)
        # a CLEAN worker exit drains _pending (submit rejects once
        # closed); anything left means the dispatcher thread died on an
        # unexpected error outside _dispatch's catch
        with self._cond:
            stranded = [
                e for entries in self._pending.values() for e in entries
            ]
            self._pending.clear()
            self._n_pending = 0
        for _, fut, _, _ in stranded:
            if not fut.done():
                fut.set_exception(
                    RuntimeError("MicroBatcher closed before dispatch")
                )

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher side ---------------------------------------------------

    def _take_batch(self) -> Tuple[List[_Entry], Optional[CompiledPipeline]]:
        """Block until there's work, pick the spec whose oldest request
        is nearest its deadline, wait that deadline out (or a full
        window, or close), and take up to max_batch of that spec."""
        with self._cond:
            while not self._n_pending and not self._closed:
                self._cond.wait()
            if not self._n_pending:
                return [], None  # closed and drained
            spec = min(
                self._pending, key=lambda s: self._pending[s][0][2]
            )
            deadline = self._pending[spec][0][2] + self.max_delay
            while (
                len(self._pending[spec]) < self.max_batch
                and not self._closed
            ):
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or not self._cond.wait(remaining):
                    break
            entries = self._pending[spec]
            batch = entries[: self.max_batch]
            del entries[: len(batch)]
            if not entries:
                del self._pending[spec]
            self._n_pending -= len(batch)
            self.metrics.set_queue_depth(self._n_pending)
            # snapshot under the lock so a concurrent swap_engine cannot
            # split a window across two engines; the hold lets a
            # displaced engine's retire() wait for this window
            self.engine.hold_window()
            return batch, self.engine

    def _loop(self) -> None:
        while True:
            batch, engine = self._take_batch()
            if not batch:
                return
            self._dispatch(batch, engine)

    def _assemble(self, examples: List[Any]) -> Any:
        """One window of raw examples -> the batched tree. Shared by the
        serial dispatch and the pipeline's host-prep stage, so both
        modes assemble identical values."""
        if self.host_featurize is not None:
            return self.host_featurize(list(examples))
        if len(examples) == 1:
            # single-entry fast path (common at low load): skip the
            # stack copy; lift to a [1, ...] VIEW of the caller's tree
            return _tree_lift(examples[0])
        return _stack(examples)

    def _dispatch(
        self, batch: List[_Entry], engine: CompiledPipeline
    ) -> None:
        examples = [ex for ex, _, _, _ in batch]
        futures = [f for _, f, _, _ in batch]
        enqueued = [t for _, _, t, _ in batch]
        metrics = engine.metrics
        metrics.record_coalesce(len(batch))
        # the window's hold on its engine (_take_batch): the pipeline
        # drops it once the window computed, the serial path here
        piped = False
        try:
            with get_tracer().span(
                "microbatch.coalesce",
                parent_id=batch[0][3],
                engine=engine.name,
                window=len(batch),
            ) as span:
                if self._pipeline is not None:
                    piped = True
                    # blocks while the prep queue is full — the lane's
                    # backpressure point
                    self._pipeline.submit_window(
                        examples, futures, enqueued, engine,
                        span.span_id,
                    )
                    return
                out = engine.apply(self._assemble(examples), sync=True)
            resolve_window_futures(metrics, out, futures, enqueued)
        except Exception as e:  # resolve, never hang callers
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            if not piped:
                engine.drop_window()
