"""Staged lane pipeline: overlap host prep, the host-to-device upload and
device compute behind one ``MicroBatcher`` (counterpart of
``keystone_tpu/serving/pipeline.py``).

A serial batcher lane runs coalesce → stack → pad → upload → compute →
deliver one window at a time, so while the card runs window k, window
k+1's host work and upload sit idle in the queue. Here the dispatch is
split into stages connected by BOUNDED handoff queues (depth ~2), each
stage on its own thread:

    coalesce ──▶ host-prep ──▶ upload ──▶ compute ──▶ deliver
    (batcher     stack or       H2D copy    replay the  copy valid
     window      host-featurize on the      bucket's    rows to the
     logic)      + pad into     engine's    CUDA graph  host, resolve
                 pooled pinned  copy        + wait      futures
                 buffer         stream      (frees pool
                                            buffer)

so window k+1's host-prep and upload overlap window k's device compute.
When a queue fills, the coalesce thread blocks and pending requests pile
up behind the batcher — backpressure is end to end, never an unbounded
pile.

**Host featurize** is the pluggable prep hook: a callable turning one
coalesced window of RAW examples into the batched array tree the engine
stages. The same hook drives the serial path, so pipelined and serial
results are bit-identical — both modes compose the engine's own stage
primitives (``host_stage``, ``upload_staged``, ``compute_staged``) over
identical values and replay the same graph.

**Buffer pool**: host-prep writes each padded window into a small
per-(bucket, spec) pool of reusable host staging buffers (``depth + 1``
per key), page-locked when the engine's device is CUDA so that the
upload is an asynchronous copy on the engine's copy stream. A buffer
returns to the pool only once its window's COMPUTE is done: on the CPU
the "uploaded" tensor is the pooled buffer itself, so the first point
the staged input is provably consumed is the compute that read it.
``reset()`` (engine swap) bumps the pool generation: in-flight windows
finish on their old engine and their buffers are dropped instead of
re-pooled.

Each stage opens a tracer span (``pipeline.host_prep`` / ``.upload`` /
``.compute`` / ``.deliver``) parented under the window's
``microbatch.coalesce`` span, and records per-stage seconds and
queue-depth series on the window's engine ``ServingMetrics``.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures._base import CANCELLED, CANCELLED_AND_NOTIFIED, FINISHED, PENDING
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability.tracing import get_tracer
from keystone_tpu_torch.parallel.dataset import _tree_map, tree_leaves

logger = logging.getLogger(__name__)

DEFAULT_DEPTH = 2

# HostFeaturize(raw examples of one window) -> batched tree of arrays
# with a leading axis of len(examples). Runs on the host-prep thread;
# must be thread-safe and pure (same window -> same values).
HostFeaturize = Callable[[List[Any]], Any]

_SENTINEL = object()


def on_host(tree: Any) -> bool:
    """True when every leaf is a host array (numpy, or a CPU tensor) —
    the poolable, host-paddable case. CUDA-tensor windows pad on the
    card through the engine's ``_stage`` instead."""
    return all(
        not (isinstance(a, torch.Tensor) and a.device.type != "cpu")
        for a in tree_leaves(tree)
    )


class HostBufferPool:
    """Reusable padded host staging buffers, keyed by
    ``(bucket, per-leaf row shape/dtype)``.

    ``acquire`` hands out a free buffer tree or allocates one
    (``allocations`` counts these — the no-growth test reads it);
    ``release`` returns it unless the pool already holds
    ``max_per_key`` for that key or the pool generation moved on (an
    engine swap retired the bucket set the buffer was cut for)."""

    def __init__(self, max_per_key: int = DEFAULT_DEPTH + 1):
        self.max_per_key = max_per_key
        self.generation = 0  # guarded-by: _lock
        self.allocations = 0  # guarded-by: _lock
        self._free: Dict[Any, List[Any]] = {}  # guarded-by: _lock
        # live staging footprint: bytes sitting free in the pool +
        # bytes riding in-flight windows (the
        # ``keystone_serving_staging_bytes`` gauge input)
        self._pooled_bytes = 0  # guarded-by: _lock
        self._outstanding_bytes = 0  # guarded-by: _lock
        # a key pins (bucket, shapes, dtypes), so its buffer size is a
        # constant — computed once per key, not per window
        self._key_bytes: Dict[Any, int] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    @staticmethod
    def _tree_bytes(buffers: Any) -> int:
        return sum(int(getattr(a, "nbytes", 0)) for a in tree_leaves(buffers))

    def _bytes_for_locked(self, key: Any, buffers: Any) -> int:
        """Cached per-key buffer size (the caller holds ``self._lock``)."""
        nbytes = self._key_bytes.get(key)
        if nbytes is None:
            nbytes = self._key_bytes[key] = self._tree_bytes(buffers)
        return nbytes

    @property
    def staging_bytes(self) -> int:
        """Total host bytes the pool currently accounts for (pooled
        free buffers + buffers riding in-flight windows)."""
        with self._lock:
            return self._pooled_bytes + self._outstanding_bytes

    def reset(self) -> None:
        """Engine swap: drop every pooled buffer and invalidate
        outstanding ones (their release becomes a no-op drop)."""
        with self._lock:
            self.generation += 1
            self._free.clear()
            self._key_bytes.clear()  # keys are cut per bucket set
            # old-generation buffers still in flight stop being
            # accounted here — their release is a drop, not a return
            self._pooled_bytes = 0
            self._outstanding_bytes = 0

    def acquire(
        self, key: Any, alloc: Callable[[], Any]
    ) -> Tuple[int, Any]:
        with self._lock:
            free = self._free.get(key)
            if free:
                buffers = free.pop()
                nbytes = self._bytes_for_locked(key, buffers)
                self._pooled_bytes -= nbytes
                self._outstanding_bytes += nbytes
                return self.generation, buffers
            self.allocations += 1
            gen = self.generation
        buffers = alloc()
        with self._lock:
            if gen == self.generation:
                self._outstanding_bytes += self._bytes_for_locked(
                    key, buffers
                )
        return gen, buffers

    def publish_staging_bytes(self, resolve_metrics: Callable[[], Any]) -> None:
        """Stamp the live footprint on ``resolve_metrics()``'s gauge,
        atomically with ``reset()``: a swap reassigns the batcher's
        current metrics BEFORE it resets this pool, and re-stamps both
        gauges AFTER, so a stage thread that selects its target and
        publishes while holding this lock can never leave a retired
        engine carrying the new pool's bytes."""
        with self._lock:
            resolve_metrics().set_staging_bytes(
                self._pooled_bytes + self._outstanding_bytes
            )

    def release(self, key: Any, generation: int, buffers: Any) -> None:
        if buffers is None:
            return  # window died before its buffers were attached
        with self._lock:
            if generation != self.generation:
                # cut for a retired engine's buckets: drop (reset()
                # already zeroed their outstanding-byte accounting)
                return
            nbytes = self._bytes_for_locked(key, buffers)
            self._outstanding_bytes -= nbytes
            free = self._free.setdefault(key, [])
            if len(free) < self.max_per_key:
                free.append(buffers)
                self._pooled_bytes += nbytes


def _to_numpy(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


_SETTLED = (CANCELLED, CANCELLED_AND_NOTIFIED, FINISHED)


class LaneFuture(Future):
    """One request's future: a ``concurrent.futures.Future`` that waits
    on its lane's condition, shared by every request of the lane, and
    makes its waiter and callback lists only when something uses them.

    A stdlib future allocates eleven objects the cyclic garbage collector
    tracks (its own condition with its lock, waiter deque and five bound
    methods, and two lists); a lane's requests live until their window is
    delivered, so those objects reach the oldest generation, whose full
    collections (119–150 ms on an H100's host, every thread stopped)
    came about once every 8,000 requests of the overlap bench row. This
    one is one tracked object. A shared condition also lets a window resolve
    all its futures under one hold of the lock with one wake-up
    (``resolve_window_futures``); since that wake-up reaches every
    waiter of the lane, a wait loops until its own future is done."""

    def __init__(self, condition: threading.Condition):
        self._condition = condition
        self._state = PENDING
        self._result = None
        self._exception = None
        # True once the waiter or the callback list exists
        self._listened = False

    def __getattr__(self, name: str):
        if name in ("_waiters", "_done_callbacks"):
            made: list = []
            setattr(self, name, made)
            self._listened = True
            return made
        raise AttributeError(name)

    def _wait_settled(self, timeout: Optional[float]) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._condition:
            while self._state not in _SETTLED:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return
                self._condition.wait(remaining)

    def result(self, timeout: Optional[float] = None) -> Any:
        self._wait_settled(timeout)
        return super().result(0)

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        self._wait_settled(timeout)
        return super().exception(0)


def resolve_window_futures(metrics, valid, futures, enqueued) -> None:
    """Deliver one window: copy ``valid`` (a tree of valid-rows outputs)
    to host numpy ONCE, resolve each future with a row VIEW of it, and
    record the completion-timed per-request latency. Shared by the
    serial batcher dispatch and the pipelined deliver stage so the two
    delivery paths cannot drift. ``futures`` are ``LaneFuture``s of one
    lane: they are set under one hold of their condition with one
    wake-up; a future the caller cancelled is skipped, and the rest of
    the window still gets its results."""
    valid = _tree_map(_to_numpy, valid)
    done = time.perf_counter()
    rows = [_tree_map(lambda a, i=i: a[i], valid) for i in range(len(futures))]
    settled = []
    condition = futures[0]._condition
    with condition:
        for i, fut in enumerate(futures):
            if fut._state in _SETTLED:
                continue
            fut._result = rows[i]
            fut._state = FINISHED
            if fut._listened:
                for waiter in fut._waiters:
                    waiter.add_result(fut)
            settled.append(i)
        condition.notify_all()
    for i in settled:
        if futures[i]._listened:
            futures[i]._invoke_callbacks()
        metrics.record_request(done - enqueued[i])


class _Window:
    """One coalesced window riding the stage queues."""

    __slots__ = (
        "examples", "futures", "enqueued", "engine", "parent_span_id",
        "tree", "rows", "bucket", "host_tree", "pool_key", "pool_gen",
        "device_tree", "ready", "valid", "fallback", "t_compute0", "held",
    )

    def __init__(self, examples, futures, enqueued, engine, parent_span_id):
        self.examples = examples
        self.futures = futures
        self.enqueued = enqueued
        self.engine = engine
        self.parent_span_id = parent_span_id
        self.tree = None          # assembled batched tree (post-prep)
        self.rows = len(examples)
        self.bucket: Optional[int] = None
        self.host_tree = None     # padded host staging (pooled)
        self.pool_key = None
        self.pool_gen = 0
        self.device_tree = None   # staged on the device, pre-compute
        self.ready = None         # the upload's CUDA event (None on CPU)
        self.valid = None         # valid rows of the output
        self.fallback = False     # rows > engine.max_bucket: serial
        # chunked apply inside the compute stage
        self.t_compute0 = 0.0
        self.held = True          # the engine's window hold (coalesce)


class LanePipeline:
    """The stage threads + handoff queues behind one pipelined
    ``MicroBatcher``. Construct via ``MicroBatcher(pipeline_depth=N)``;
    windows enter through ``submit_window`` on the batcher's coalesce
    thread and leave by resolving their request futures in deliver."""

    # stage order drives thread wiring and queue-depth attribution
    STAGES = ("host_prep", "upload", "compute", "deliver")

    def __init__(
        self,
        assemble: Callable[[List[Any]], Any],
        depth: int = DEFAULT_DEPTH,
        name: str = "lane",
        current_metrics: Optional[Callable[[], Any]] = None,
    ):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth
        self.name = name
        self._assemble = assemble
        # the staging pool belongs to the LANE, so its byte gauge
        # tracks the engine currently serving it — a window that
        # outlives a swap must not stamp the new pool's footprint onto
        # its retired coalesce-time engine (double-counted series)
        self._current_metrics = current_metrics
        self.pool = HostBufferPool(max_per_key=depth + 1)
        self._queues: Dict[str, "queue.Queue"] = {
            s: queue.Queue(maxsize=depth) for s in self.STAGES
        }
        self._closed = False
        self._threads = [
            threading.Thread(
                target=self._stage_loop,
                args=(stage,),
                name=f"keystone-{name}-{stage}",
                daemon=True,
            )
            for stage in self.STAGES
        ]
        for t in self._threads:
            t.start()

    def _publish_staging_bytes(self, fallback_engine) -> None:
        resolve = self._current_metrics
        self.pool.publish_staging_bytes(
            resolve if resolve is not None
            else lambda: fallback_engine.metrics
        )

    # -- intake (the batcher's coalesce thread) ----------------------------

    def submit_window(
        self,
        examples: List[Any],
        futures: List,
        enqueued: List[float],
        engine,
        parent_span_id: Optional[int],
    ) -> None:
        """Hand one coalesced window to the stage chain. BLOCKS while
        the host-prep queue is full — that block is the backpressure
        signal."""
        w = _Window(examples, futures, enqueued, engine, parent_span_id)
        self._queues["host_prep"].put(w)
        engine.metrics.set_stage_queue_depth(
            "host_prep", self._queues["host_prep"].qsize()
        )

    # -- stage threads -----------------------------------------------------

    def _stage_loop(self, stage: str) -> None:
        inbox = self._queues[stage]
        i = self.STAGES.index(stage)
        outbox = (
            self._queues[self.STAGES[i + 1]]
            if i + 1 < len(self.STAGES) else None
        )
        fn = getattr(self, f"_{stage}")
        while True:
            w = inbox.get()
            if w is _SENTINEL:
                if outbox is not None:
                    outbox.put(_SENTINEL)
                return
            t0 = time.perf_counter()
            try:
                with get_tracer().span(
                    f"pipeline.{stage}",
                    parent_id=w.parent_span_id,
                    engine=w.engine.name,
                    window=len(w.futures),
                    bucket=w.bucket or 0,
                ):
                    fn(w)
                w.engine.metrics.record_stage(
                    stage, time.perf_counter() - t0
                )
            except Exception as e:
                self._fail_window(w, e)
                continue
            w.engine.metrics.set_stage_queue_depth(stage, inbox.qsize())
            if outbox is not None:
                outbox.put(w)

    @staticmethod
    def _drop_engine(w: _Window) -> None:
        """Give up the window's hold on its engine (taken at coalesce):
        once the window computed, or failed."""
        if w.held:
            w.held = False
            w.engine.drop_window()

    def _fail_window(self, w: _Window, err: Exception) -> None:
        """Resolve every future with the stage error (never hang
        callers), recycle any pooled buffer the window held and drop
        its hold on the engine."""
        self._drop_engine(w)
        if w.pool_key is not None:
            if w.ready is not None:
                # the copy may still be reading the pinned buffer
                w.ready.synchronize()
            self.pool.release(w.pool_key, w.pool_gen, w.host_tree)
            w.pool_key = None
        for fut in w.futures:
            if not fut.done():
                try:
                    fut.set_exception(err)
                except Exception:
                    pass  # caller cancelled concurrently

    # stage 2: assemble (stack / host featurize) + pad on the host into a
    # pooled staging buffer
    def _host_prep(self, w: _Window) -> None:
        engine = w.engine
        # chaos point: stall the prep stage. The sleep holds THIS stage
        # thread, so the bounded handoff queues fill and submit_window
        # blocks — the end-to-end backpressure chain.
        if faults.armed():
            spec = faults.fire(
                "pipeline.host_prep.stall", {"engine": engine.name}
            )
            if spec is not None and spec.delay_ms > 0:
                time.sleep(spec.delay_ms / 1e3)
        w.tree = self._assemble(w.examples)
        w.examples = None  # window owns the batched tree from here
        w.rows = tree_leaves(w.tree)[0].shape[0]
        if w.rows > engine.max_bucket:
            # a pinned max_batch wider than a post-swap engine's largest
            # bucket: fall back to the engine's chunked serial apply in
            # the compute stage (degraded, never wrong)
            w.fallback = True
            return
        w.bucket = engine.bucket_for(w.rows)
        if not on_host(w.tree):
            # CUDA-tensor window: pad on the card like the serial path;
            # upload becomes a pass-through
            w.device_tree = engine._stage(w.tree, w.rows, w.bucket)
            w.tree = None
            return
        key = engine.host_key(w.tree, w.bucket)
        tree, bucket = w.tree, w.bucket
        w.pool_gen, buffers = self.pool.acquire(
            key, lambda: engine.alloc_host(tree, bucket)
        )
        w.pool_key = key
        self._publish_staging_bytes(engine)
        # attach the buffers to the window BEFORE the fill: if
        # host_stage raises (e.g. a leaf with a mismatched leading dim),
        # _fail_window must recycle the real buffers
        w.host_tree = buffers
        engine.host_stage(w.tree, w.rows, bucket, out=buffers)
        w.tree = None

    # stage 3: the host-to-device copy on the engine's copy stream; the
    # stage waits for it, so its seconds are the copy's. The pooled host
    # buffer is NOT released here (see the module docstring): it rides
    # with the window and frees once its compute is done.
    def _upload(self, w: _Window) -> None:
        if w.fallback or w.device_tree is not None:
            return
        w.device_tree, w.ready = w.engine.upload_staged(w.host_tree)
        if w.ready is not None:
            # lint: disable=hot-path-host-sync
            # this stage's own thread waits for its copy (its seconds are
            # the copy's) while the compute stage runs the window before
            w.ready.synchronize()

    # stage 4: replay the bucket's graph and wait for it; the wait here is
    # the completion-timed dispatch number the serial path records at
    # apply(sync=True)
    def _compute(self, w: _Window) -> None:
        engine = w.engine
        w.t_compute0 = time.perf_counter()
        if w.fallback:
            # oversized window (pinned max_batch > a post-swap engine's
            # largest bucket): the engine's chunked serial apply
            w.valid = engine.apply(w.tree, sync=True)
            w.tree = None
            self._drop_engine(w)
            return
        w.valid = engine.compute_staged(w.device_tree, w.rows, w.bucket, w.ready)
        w.device_tree = None
        # lint: disable=hot-path-host-sync
        # this stage's own thread waits for the replay: the dispatch is
        # timed to completion, and the pooled buffer is released after it
        engine.synchronize()
        self._drop_engine(w)
        engine.metrics.record_dispatch_complete(
            time.perf_counter() - w.t_compute0
        )
        if w.pool_key is not None:
            # compute done == inputs consumed: the pooled host buffer
            # is finally safe to hand to a later window's prep
            self.pool.release(w.pool_key, w.pool_gen, w.host_tree)
            w.pool_key = None
            w.host_tree = None
            self._publish_staging_bytes(engine)

    # stage 5: copy the valid rows to the host, resolve futures, close
    # the loop on request latency + window-rate series
    def _deliver(self, w: _Window) -> None:
        metrics = w.engine.metrics
        resolve_window_futures(metrics, w.valid, w.futures, w.enqueued)
        w.valid = None
        metrics.record_window()

    # -- lifecycle ---------------------------------------------------------

    def on_swap(self) -> None:
        """Engine swapped behind the batcher: rebuild the staging pool
        (bucket sizes may have changed). Windows already in the stages
        carry their coalesce-time engine and finish on it; their
        buffers drop instead of re-pooling (generation bump)."""
        self.pool.reset()

    def close(self, timeout: Optional[float] = 10.0) -> None:
        """Flush in-flight windows through every stage and stop the
        threads. Caller (``MicroBatcher.close``) has already drained
        its pending queue into ``submit_window``."""
        if self._closed:
            return
        self._closed = True
        self._queues["host_prep"].put(_SENTINEL)
        deadline = (
            time.perf_counter() + timeout if timeout is not None else None
        )
        for t in self._threads:
            remaining = (
                None if deadline is None
                else max(0.1, deadline - time.perf_counter())
            )
            t.join(remaining)
        if any(t.is_alive() for t in self._threads):
            logger.warning(
                "lane pipeline %s still draining after %.1fs close "
                "timeout (graph capture in flight?); in-flight futures "
                "resolve as it finishes", self.name, timeout,
            )


__all__ = [
    "DEFAULT_DEPTH",
    "HostBufferPool",
    "HostFeaturize",
    "LaneFuture",
    "LanePipeline",
]
