"""Bucketed execution of a ``FittedPipeline`` with one CUDA graph per
bucket (counterpart of ``keystone_tpu/serving/engine.py``
``CompiledPipeline``).

A ``CompiledPipeline`` fixes a small set of row buckets, zero-pads each
incoming batch up to the smallest covering bucket and dispatches the
bucket's program; batches larger than the largest bucket are chunked
through it. Zero pad rows are safe by the ``Dataset`` padding
discipline; outputs are sliced back to the valid rows.

**One CUDA graph per bucket** is the counterpart of the JAX engine's
per-bucket XLA program. A bucket's first dispatch (or ``warmup``, before
traffic) runs one warm eager pass of ``featurize∘pipeline`` on the
bucket's shape — it fills the SIFT/LCS operator and band caches, the
gray weights and the libraries' per-stream state, so that the capture
finds no host work — then captures ``featurize._batch_run`` and
``pipeline._batch_run`` into a ``torch.cuda.CUDAGraph`` that reads a
static ``(bucket, ...)`` input and writes a static output. Every
dispatch copies its uploaded batch into the static input on the
engine's compute stream, replays the graph and clones the valid rows of
the output before the next replay can overwrite it. A capture counts on
``metrics.record_trace`` (``compile_count``: at most one per bucket and
example spec). On the card a capture or replay that fails raises;
nothing drops back to eager dispatch. On CPU tensors there is no graph:
the engine runs the chain eagerly there, as the kernels run their plain
versions there.

The kernels' wrappers count launches in Python, so a replay would count
nothing: each graph keeps the launches its capture made
(``_cuda.capture_tally``) and adds them to ``_cuda.LAUNCHES`` on every
replay.

The dispatch path is factored into stage primitives so the staged lane
pipeline (``serving/pipeline.py``) can run them on separate threads —
``host_stage`` (pad on the host into a pooled buffer, page-locked when
the device is CUDA), ``upload_staged`` (a ``non_blocking`` copy on the
engine's copy stream, returning the device tree and a CUDA event) and
``compute_staged`` (the compute stream waits on that event, replays the
bucket's graph, records the dispatch) — while the serial
``apply``/``_dispatch`` path composes exactly the same primitives
inline, which is what makes pipelined results bit-identical to serial
ones.

``featurize=`` puts a second fitted pipeline (e.g. the flagship
SIFT+LCS→FV chain) in front of the model inside every bucket's graph:
callers send raw examples (uint8 images), which are padded on the host
and copied to the device once per dispatch.

``aot_store=`` (``serving/aot.py``): ``warmup`` first takes the kernel
libraries the build directory lacks from the store (a host with the
store skips ``nvcc``), then, per bucket, an entry keyed by the bucket's
fingerprint: the operators the chain prepares for the bucket's shape go
back on the card before the warm pass and the capture, and a replay of
a probe batch must give the stored output bit for bit (``aot_report``).
A miss, a corrupt entry or a probe that disagrees is counted and the
bucket is built cold, on the same device with the same kernels, and
saved. A CUDA graph itself cannot be serialized: a hit still captures
(``compile_count`` counts captures).

``param_sharding=`` (``serving/sharding.py``) resolves the model's
partition specs over the process mesh and runs the model through a
``ParamBinder`` on params the engine placed itself; on one card every
spec places its param whole, and the caller's pipeline is untouched.

Not ported: input donation and the per-bucket cost model (no compiler
cost analysis to read).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch import _cuda
from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.loadgen import faults
from keystone_tpu_torch.observability import device as device_obs
from keystone_tpu_torch.observability.tracing import get_tracer
from keystone_tpu_torch.parallel.dataset import Dataset, _leading_dim, _tree_map
from keystone_tpu_torch.serving.metrics import ServingMetrics
from keystone_tpu_torch.serving.pipeline import HostBufferPool, on_host, tree_leaves

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (8, 64, 512)


def _dtype(a: Any) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    # lint: disable=hot-path-host-sync
    # a leaf that is not a tensor is host data: no device read
    return torch.from_numpy(np.empty(0, np.asarray(a).dtype)).dtype


def _row_spec(tree: Any, drop: int = 1) -> Any:
    """The tree's structure with each leaf's per-row shape and dtype."""
    if isinstance(tree, tuple):
        return tuple(_row_spec(t, drop) for t in tree)
    shape = tuple(tree.shape) if hasattr(tree, "shape") else np.shape(tree)
    return (tuple(shape[drop:]), _dtype(tree))


def _zip_map(fn, a: Any, b: Any) -> Any:
    if isinstance(a, tuple):
        return tuple(_zip_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


@dataclasses.dataclass
class BucketGraph:
    """One bucket's captured CUDA graph: its static input and output
    trees, the kernel launches one replay makes, the seconds the warm
    pass and capture took, and the device memory its private pool
    reserved."""

    bucket: int
    graph: Any
    static_in: Any
    static_out: Any
    launches: Dict[str, int]
    capture_s: float
    pool_bytes: int
    # what the capture's kernels read beside static_in (the SIFT and LCS
    # operators, out of their bounded caches), kept for the graph's life
    refs: List[Any] = dataclasses.field(default_factory=list)


class CompiledPipeline:
    """A ``FittedPipeline`` behind a fixed set of batch shapes.

    Parameters
    ----------
    pipeline:  the fitted (transformer-only) pipeline, with its parameters
               on ``device``; its batched apply path must run without
               host syncs on the card, or the graph capture raises.
    buckets:   row buckets; a batch of n rows dispatches the smallest
               bucket >= n, and larger batches are chunked through the
               biggest.
    featurize: optional fitted featurize pipeline run in front of
               ``pipeline`` inside every bucket's graph: callers send raw
               examples.
    device:    where the staged batches go; ``None`` means ``cuda`` and
               raises when CUDA is missing.
    metrics:   the ``ServingMetrics`` to record into (a fresh one by
               default); registered into the global registry under
               ``name``.
    aot_store: ``"auto"`` (the store ``aot.setup_aot_cache`` configured
               for this process, or none), None/False (off), or an
               ``aot.AotStore``; consulted by ``warmup`` only.
    param_sharding: None, True (``sharding.DEFAULT_RULES``), rules, or
               resolved specs: the model's params placed by the engine
               over the process mesh (``sharding.current_mesh``);
               ``param_sharding_unmatched="replicate"`` replicates
               params no rule matches instead of raising.
    """

    def __init__(
        self,
        pipeline,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        *,
        featurize: Any = None,
        device=None,
        metrics: Optional[ServingMetrics] = None,
        name: Optional[str] = None,
        aot_store: Any = "auto",
        param_sharding: Any = None,
        param_sharding_unmatched: str = "error",
    ):
        if not buckets:
            raise ValueError("need at least one bucket")
        if any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive: {buckets}")
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self.featurize = featurize
        self._binder = None
        self.param_sharding: Optional[Dict[str, Any]] = None
        self._placed_params: Optional[Dict[str, torch.Tensor]] = None
        self.mesh = None
        if param_sharding:
            from keystone_tpu_torch.serving import sharding as sharding_lib

            self.mesh = sharding_lib.current_mesh()
            self._binder = sharding_lib.ParamBinder(pipeline)
            self.param_sharding = sharding_lib.resolve_param_sharding(
                param_sharding, pipeline, params=self._binder.params,
                unmatched=param_sharding_unmatched,
            )
            shard_fns = sharding_lib.make_shard_fns(self.param_sharding, self.mesh, self.device)
            self._placed_params = {
                name: fn(self._binder.params[name]) for name, fn in shard_fns.items()
            }
        self.model_sharded = self._binder is not None
        # "auto" = the process-configured store (aot.configured_store),
        # None/False = off, or an AotStore; read by warmup only
        self._aot_store_cfg = aot_store
        # bucket -> {"status": "hit"|"saved"|"miss"|"error", ...}
        self._aot: Dict[int, Dict[str, Any]] = {}
        # kernel library -> where warmup took it from (aot.install_libraries),
        # and the seconds that took
        self.aot_libraries: Dict[str, str] = {}
        self.aot_libraries_s = 0.0
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b) for b in buckets)))
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # every engine is scrapeable through the global MetricsRegistry
        # (weakref bridge) under the `engine` label
        self.name = self.metrics.register(engine=name)
        self.metrics.set_device_peaks(*device_obs.peaks_of(self.device))
        # (bucket, example spec) -> its captured graph
        self._graphs: Dict[Any, BucketGraph] = {}
        # a MicroBatcher's compute thread and direct apply() callers may
        # race to capture a bucket; two captures would break the
        # <= len(buckets) compile bound
        self._fn_lock = threading.Lock()
        # a replay reads the static input and writes the static output:
        # the copy in, the replay and the clone out go onto the compute
        # stream together
        self._replay_lock = threading.Lock()
        # pinned staging buffers of the serial path (the lane pipeline
        # keeps its own pool)
        self._staging = HostBufferPool(max_per_key=2)
        # windows a MicroBatcher took for this engine and has not
        # computed yet; once ``retire`` was called, the last of them to
        # finish releases the graphs
        self._windows = 0
        self._retired = False
        self._windows_lock = threading.Lock()
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.Stream(self.device)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n`` rows (callers chunk above the
        largest bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the largest bucket "
            f"{self.max_bucket}; chunk it (engine.apply does)"
        )

    # -- staging -----------------------------------------------------------

    def _stage(self, tree: Any, rows: int, bucket: int) -> Any:
        """Pad a tensor (or tuple of tensors) up to ``bucket`` rows with
        zeros on its own device and place it on the engine's device (the
        path of batches that arrive on the card)."""
        pad = bucket - rows

        def pad_leaf(a):
            if not isinstance(a, torch.Tensor):
                # lint: disable=hot-path-host-sync
                # a leaf that is not a tensor is host data: no device read
                a = torch.as_tensor(np.asarray(a))
            if pad:
                a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
            return a.to(self.device)

        return _tree_map(pad_leaf, tree)

    def host_key(self, tree: Any, bucket: int) -> Any:
        """The staging-pool key of a host batch: the bucket and the
        tree's per-row shapes and dtypes."""
        return bucket, _row_spec(tree)

    def alloc_host(self, tree: Any, bucket: int) -> Any:
        """Zeroed ``(bucket, ...)`` host buffers matching ``tree``,
        page-locked when the engine's device is CUDA (``pin_memory``
        needs a card, so on the CPU they are plain)."""
        pin = self.device.type == "cuda"
        return _tree_map(
            lambda a: torch.zeros(
                (bucket,) + _row_spec(a)[0], dtype=_dtype(a), pin_memory=pin
            ),
            tree,
        )

    # -- pipeline stage primitives (serving/pipeline.py runs these on
    # -- separate threads; _dispatch composes them inline) ------------------

    def host_stage(self, tree: Any, rows: int, bucket: int, out: Any) -> Any:
        """HOST-side pad of a host batch up to ``bucket`` rows with zeros
        — the pipelined host-prep stage. ``out`` is a matching tree of
        preallocated ``(bucket, ...)`` buffers (``alloc_host``; the
        reusable staging pool): valid rows are copied in and the pad
        region zeroed, so steady-state windows allocate nothing on the
        host. Returns ``out``."""
        def fill_leaf(buf, a):
            buf[:rows].copy_(torch.as_tensor(a))
            if bucket > rows:
                buf[rows:].zero_()
            return buf

        return _zip_map(fill_leaf, out, tree)

    def upload_staged(self, staged_host: Any) -> Tuple[Any, Optional[Any]]:
        """Host-to-device copy of a host-staged (already padded) tree —
        the pipelined upload stage. On CUDA the copies are
        ``non_blocking`` from the pinned buffers, on the engine's copy
        stream; returns ``(device tree, event)``, the event recorded on
        the copy stream after the copies (the host buffers may be reused
        once it has completed). On the CPU the host tree IS the device
        tree and the event is None."""
        if self.device.type != "cuda":
            return staged_host, None
        with torch.cuda.stream(self._copy_stream):
            staged = _tree_map(
                lambda a: a.to(self.device, non_blocking=True), staged_host
            )
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return staged, ready

    def compute_staged(
        self, staged: Any, rows: int, bucket: int, ready: Optional[Any] = None
    ) -> Any:
        """Run the bucket's program over an already-staged (padded and
        placed) tree and record the dispatch counters: on CUDA, the
        compute stream waits on ``ready`` (the upload's event) and on the
        caller's stream, copies ``staged`` into the graph's static input
        and replays the graph (capturing it first if this bucket has
        none yet). Returns the ``rows`` valid rows of the output, cloned
        (the next replay overwrites the static output); the caller's
        current stream is ordered after them."""
        # chaos point: fail the whole window at dispatch (match:
        # engine=<name>). Serial apply and the pipelined compute stage
        # both pass through here.
        if faults.armed() and faults.fire(
            "engine.dispatch.error", {"engine": self.name}
        ) is not None:
            raise faults.FaultInjected(
                "engine.dispatch.error", engine=self.name, bucket=bucket
            )
        # the wire-bytes fact: what this dispatch staged, padded rows
        # included (shape metadata, no device read)
        h2d_bytes = sum(int(a.nbytes) for a in tree_leaves(staged))
        if self.device.type == "cuda":
            valid = self._replay(self._graph(bucket, staged), staged, rows, ready)
        else:
            valid = _tree_map(lambda a: a[:rows].clone(), self._run_bucket(staged))
        self.metrics.record_dispatch(bucket, rows, h2d_bytes=h2d_bytes)
        return valid

    def synchronize(self) -> None:
        """Wait until the caller's current stream (which every returned
        output is ordered on) has finished."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # -- the graph per bucket ----------------------------------------------

    def _run_bucket(self, staged: Any) -> Any:
        """The chain, eagerly: ``featurize`` then ``pipeline`` (through
        the binder, on the engine's placed params, when sharded)."""
        if self.featurize is not None:
            staged = self.featurize._batch_run(staged)
        if self._binder is not None:
            return self._binder.run(self._placed_params, staged)
        return self.pipeline._batch_run(staged)

    def _graph(self, bucket: int, staged: Any) -> BucketGraph:
        key = (bucket, _row_spec(staged))
        g = self._graphs.get(key)
        if g is not None:
            return g
        # a capture records everything enqueued on the compute stream,
        # so replays (on that stream, under _replay_lock) wait for it
        with self._fn_lock, self._replay_lock:
            g = self._graphs.get(key)
            if g is None:
                # lint: disable=blocking-under-lock
                # captures are serialized on purpose: at most one per
                # bucket (the compile bound), and none beside a replay;
                # warmup captures every bucket before traffic
                g = self._graphs[key] = self._capture(bucket, staged)
            return g

    def _capture(self, bucket: int, staged: Any) -> BucketGraph:
        """Warm pass, capture and one checking replay of ``bucket``'s
        graph for ``staged``'s spec, on the compute stream.
        ``capture_error_mode="thread_local"``: a capture at a bucket's
        first dispatch runs on the lane's compute thread while the other
        stage threads copy and allocate."""
        t0 = time.perf_counter()
        stream = self._compute_stream
        static_in = _tree_map(torch.zeros_like, staged)
        with torch.cuda.stream(stream):
            stream.wait_stream(torch.cuda.current_stream(self.device))
            self._run_bucket(static_in)
        stream.synchronize()
        graph = torch.cuda.CUDAGraph()
        refs: List[Any] = []
        with _cuda.capture_tally(refs) as launches:
            # its entry empties the caching allocator first
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                static_out = self._run_bucket(static_in)
        pool_bytes = _pool_bytes(graph, self.device)
        with torch.cuda.stream(stream):
            graph.replay()
        _cuda.add_launches(launches)
        stream.synchronize()
        self.metrics.record_trace(bucket)
        return BucketGraph(
            bucket, graph, static_in, static_out, dict(launches),
            time.perf_counter() - t0, pool_bytes, refs,
        )

    def _replay(self, g: BucketGraph, staged: Any, rows: int, ready) -> Any:
        stream = self._compute_stream
        caller = torch.cuda.current_stream(self.device)
        with self._replay_lock, torch.cuda.stream(stream):
            # the staged tensors were written on the copy stream (an
            # upload, ``ready``) or on the caller's stream (a batch padded
            # on the card)
            stream.wait_stream(caller)
            if ready is not None:
                stream.wait_event(ready)
            for src, dst in zip(tree_leaves(staged), tree_leaves(g.static_in)):
                # the caching allocator must not hand src's memory to the
                # next upload while this stream still reads it
                src.record_stream(stream)
                dst.copy_(src)
            g.graph.replay()
            _cuda.add_launches(g.launches)
            valid = _tree_map(lambda a: a[:rows].clone(), g.static_out)
            done = torch.cuda.Event()
            done.record(stream)
        caller.wait_event(done)
        for a in tree_leaves(valid):
            a.record_stream(caller)
        return valid

    def release_graphs(self) -> int:
        """Drop every captured graph and its private memory pool, once no
        window will dispatch here again (a zoo unit's lanes are closed).
        Waits only for this engine's own compute stream, and does not
        empty the caching allocator (``empty_cache`` would synchronize
        the whole card, other units' replays included): the freed pool
        stays reserved until the next ``empty_cache``, which every
        capture calls first. Returns the number of graphs released; a
        later dispatch captures anew."""
        with self._fn_lock, self._replay_lock:
            graphs = list(self._graphs.values())
            self._graphs.clear()
            if graphs and self.device.type == "cuda":
                # lint: disable=blocking-under-lock
                # the engine's own stream, after its last window: no
                # replay may start between this wait and the reset
                self._compute_stream.synchronize()
            for g in graphs:
                g.static_in = g.static_out = None
                g.refs.clear()
                g.graph.reset()
        return len(graphs)

    def hold_window(self) -> None:
        """A batcher took one window for this engine (under the lock its
        ``swap_engine`` takes, so a swap cannot slip in between)."""
        with self._windows_lock:
            self._windows += 1

    def drop_window(self) -> None:
        """That window's compute finished, or the window failed: the last
        window of a retired engine releases its graphs."""
        with self._windows_lock:
            self._windows -= 1
            last = self._retired and self._windows == 0
        if last:
            self.release_graphs()

    def retire(self) -> int:
        """The release of an engine a swap displaced, without waiting:
        its graphs go now if no window a batcher took for it is still
        computing, else when the last of them finishes (``drop_window``).
        Returns the graphs released now."""
        with self._windows_lock:
            self._retired = True
            now = self._windows == 0
        return self.release_graphs() if now else 0

    def graph_report(self) -> List[Dict[str, Any]]:
        """One entry per captured graph: bucket, capture seconds (warm
        pass included), the bytes its private memory pool reserved, and
        the launches of one replay."""
        return [
            {"bucket": g.bucket, "capture_s": g.capture_s,
             "pool_bytes": g.pool_bytes, "launches": dict(g.launches)}
            for g in self._graphs.values()
        ]

    # -- serving entry points ----------------------------------------------

    def apply(self, data: Any, sync: bool = False) -> Any:
        """Serve one batch: pad to the covering bucket (chunking through
        the largest bucket when oversized), dispatch, and return outputs
        sliced to the valid rows, on the engine's device. ``sync=True``
        waits for the device to finish and records the completion-timed
        dispatch latency."""
        if isinstance(data, Dataset):
            rows = data.n
            tree = data.array()
        else:
            tree = data
            rows = _leading_dim(tree)
        if rows == 0:
            raise ValueError("cannot serve an empty batch")
        outs: List[Any] = []
        t0 = time.perf_counter()
        start = 0
        while start < rows:
            take = min(self.max_bucket, rows - start)
            chunk = _tree_map(lambda a: a[start : start + take], tree)
            outs.append(self._dispatch(chunk, take))
            start += take
        if len(outs) == 1:
            result = outs[0]
        else:
            result = _zip_cat(outs)
        if sync:
            # lint: disable=hot-path-host-sync
            # the wait the caller asked for
            self.synchronize()
            self.metrics.record_dispatch_complete(time.perf_counter() - t0)
        return result

    def _dispatch(self, chunk: Any, rows: int) -> Any:
        bucket = self.bucket_for(rows)
        with get_tracer().span(
            "serving.dispatch", engine=self.name, bucket=bucket, rows=rows
        ):
            t0 = time.perf_counter()
            if not on_host(chunk):
                out = self.compute_staged(self._stage(chunk, rows, bucket), rows, bucket)
            else:
                key = self.host_key(chunk, bucket)
                gen, host = self._staging.acquire(
                    key, lambda: self.alloc_host(chunk, bucket)
                )
                ready = None
                try:
                    self.host_stage(chunk, rows, bucket, host)
                    staged, ready = self.upload_staged(host)
                    out = self.compute_staged(staged, rows, bucket, ready)
                finally:
                    # the copy has read the pinned buffer once `ready` is
                    # done (on the CPU, the eager compute has)
                    if ready is not None:
                        # lint: disable=hot-path-host-sync
                        # the H2D copy only (the compute stays queued):
                        # the pinned buffer goes back to the pool after it
                        ready.synchronize()
                    self._staging.release(key, gen, host)
            self.metrics.record_dispatch_enqueue(time.perf_counter() - t0)
        return out

    def warmup(
        self,
        example: Any = None,
        batch: Any = None,
        buckets: Optional[Sequence[int]] = None,
    ) -> Dict[int, float]:
        """Capture every bucket's graph up front, before traffic (zero
        captures at traffic time). The per-example shape/dtype spec comes
        from ``example`` (ONE example, no leading axis) or ``batch``
        (WITH a leading axis). With an AOT store, the kernel libraries
        and each bucket's entry come from the store first (module
        docstring). Returns bucket -> seconds (warm pass, capture and a
        checking replay, a hit's load and probe included; on the CPU,
        one eager run)."""
        if (example is None) == (batch is None):
            raise ValueError("pass exactly one of example= or batch=")
        if isinstance(batch, Dataset):
            batch = batch.array()
        spec = _row_spec(batch if batch is not None else example,
                         drop=1 if batch is not None else 0)
        want = list(buckets) if buckets is not None else list(self.buckets)
        unknown = [b for b in want if b not in self.buckets]
        if unknown:  # validate BEFORE capturing anything
            raise ValueError(
                f"unknown bucket(s) {unknown} (have {self.buckets})"
            )
        store = self._resolve_aot_store()
        fingerprint = None
        if store is not None:
            from keystone_tpu_torch.serving import aot as aot_lib

            try:
                fingerprint = self._fingerprint(aot_lib)
            except Exception:
                # a pipeline that cannot be fingerprinted warms as with
                # no store: counted, logged, built cold
                store.record_error()
                logger.info("aot: could not fingerprint the pipeline; warming "
                            "without the store", exc_info=True)
                store = None
        if store is not None and self.device.type == "cuda":
            # before anything launches: a library the build directory
            # lacks comes from the store instead of nvcc
            t_lib = time.perf_counter()
            self.aot_libraries = aot_lib.install_libraries(store)
            self.aot_libraries_s = time.perf_counter() - t_lib
        specs = _spec_leaves(spec)
        times: Dict[int, float] = {}
        for b in want:
            t0 = time.perf_counter()
            key = meta = None
            if store is not None:
                key, meta = aot_lib.bucket_key(
                    specs, self.buckets, b, donate=False, shard=False,
                    namespace=getattr(store, "namespace", None), **fingerprint,
                )
                if self._try_install_aot(store, key, meta, b, spec):
                    times[b] = time.perf_counter() - t0
                    continue
            self._warm_bucket(b, spec)
            if store is not None:
                self._save_aot(store, key, meta, b, spec)
            times[b] = time.perf_counter() - t0
        if store is not None and self.device.type == "cuda":
            aot_lib.save_libraries(store)
        return times

    def _warm_bucket(self, bucket: int, spec: Any) -> None:
        staged = _spec_map(
            lambda s: torch.zeros((bucket,) + s[0], dtype=s[1], device=self.device), spec
        )
        if self.device.type == "cuda":
            self._graph(bucket, staged)
        else:
            self._run_bucket(staged)

    # -- the AOT store (serving/aot.py) ---------------------------------------

    def _resolve_aot_store(self):
        """The store warmup consults: the process-configured one for
        ``"auto"``, None when off, or the ``AotStore`` given."""
        if self._aot_store_cfg in (None, False):
            return None
        if self._aot_store_cfg == "auto":
            from keystone_tpu_torch.serving import aot as aot_lib

            return aot_lib.configured_store()
        return self._aot_store_cfg

    def _fingerprint(self, aot_lib) -> Dict[str, Any]:
        """The warmup-invariant ``bucket_key`` fields: the model's and
        the featurize chain's tokens, the sharding token, the runtime."""
        out = {
            "model_token": aot_lib.pipeline_token(self.pipeline),
            "featurize_token": (
                aot_lib.pipeline_token(self.featurize) if self.featurize is not None else None
            ),
            "sharding_token": None,
            "identity": aot_lib.runtime_identity(self.device),
        }
        if self.model_sharded:
            from keystone_tpu_torch.serving import sharding as sharding_lib

            out["sharding_token"] = sharding_lib.sharding_token(self.param_sharding, self.mesh)
        return out

    def _operator_nodes(self):
        """``(name, op)`` of every node of the chain that keeps per-shape
        operators (an ``_operator_cache``: the SIFT and LCS extractors),
        named by chain, topo position and class."""
        chains = (("featurize", self.featurize),
                  ("pipeline", self._binder._pipeline if self._binder is not None
                   else self.pipeline))
        for prefix, fitted in chains:
            if fitted is None:
                continue
            for i, nid in enumerate(fitted._topo):
                op = fitted.graph.operators[nid]
                if callable(getattr(op, "operators", None)):
                    yield f"{prefix}/{i}/{type(op).__name__}", op

    def _device_tag(self) -> str:
        # what a tensor on this engine's device reports as its device:
        # the operator caches key on it
        return str(torch.empty(0, device=self.device).device)

    def _export_operators(self) -> Dict[str, Dict[str, Any]]:
        tag = self._device_tag()
        out: Dict[str, Dict[str, Any]] = {}
        for name, op in self._operator_nodes():
            cache = op.__dict__.get("_operator_cache")
            if cache is None:
                continue
            out[name] = {
                repr(tuple(k[:-1])): cache.get(k) for k in cache.keys() if k[-1] == tag
            }
        return out

    def _install_operators(self, stored: Dict[str, Dict[str, Any]]) -> None:
        """Put stored operators on this engine's device into the caches
        of the nodes they were taken from (same dtype and layout)."""
        import ast

        from keystone_tpu_torch.utils.lru import LRUCache

        tag = self._device_tag()
        nodes = dict(self._operator_nodes())
        for name, entries in stored.items():
            op = nodes.get(name)
            if op is None:
                raise ValueError(f"stored operators of {name}, which this chain lacks")
            cache = op.__dict__.setdefault("_operator_cache", LRUCache())
            for k, value in entries.items():
                cache.put(tuple(ast.literal_eval(k)) + (tag,), _tree_to(value, self.device))

    def _clear_operators(self) -> None:
        """Forget every prepared operator (a graph keeps what it reads)."""
        for _, op in self._operator_nodes():
            op.__dict__.pop("_operator_cache", None)

    def _probe(self, bucket: int, spec: Any) -> Any:
        """The bucket's output, on the CPU, for a probe batch derived
        from the spec: a fixed pattern of values below 251 (floats
        scaled into [0, 1)), so that every node sees varied input."""
        def leaf(s):
            shape, dtype = (bucket,) + s[0], s[1]
            n = int(np.prod(shape))
            v = ((torch.arange(n, dtype=torch.int64) * 40503 + 17) % 251).reshape(shape)
            v = v.to(dtype) / 251 if dtype.is_floating_point else v.to(dtype)
            return v.to(self.device)

        probe = _spec_map(leaf, spec)
        if self.device.type == "cuda":
            out = self._replay(self._graph(bucket, probe), probe, bucket, None)
            torch.cuda.current_stream(self.device).synchronize()
        else:
            out = self._run_bucket(probe)
        return _tree_map(lambda a: a.detach().cpu(), out)

    def _drop_graph(self, bucket: int, spec: Any) -> None:
        key = (bucket, spec)
        with self._fn_lock, self._replay_lock:
            g = self._graphs.pop(key, None)
            if g is not None and self.device.type == "cuda":
                # lint: disable=blocking-under-lock
                # a graph that failed its warmup check: no replay may
                # start between this wait and the reset
                self._compute_stream.synchronize()
                g.static_in = g.static_out = None
                g.refs.clear()
                g.graph.reset()

    def _try_install_aot(self, store, key, meta, bucket: int, spec: Any) -> bool:
        """Install one bucket from the store: its operators, its warm
        pass and capture, then the probe against the stored output.
        True on a hit; on a miss or an error (counted) False, with the
        graph and the installed operators dropped. Never raises."""
        t0 = time.perf_counter()
        payload, outcome = store.load(key, meta)
        if payload is None:
            self._aot[bucket] = {"status": outcome}
            return False
        try:
            self._install_operators(payload.get("operators", {}))
            self._warm_bucket(bucket, spec)
            if not _tree_equal(self._probe(bucket, spec), payload["output"]):
                raise ValueError("the probe's output differs from the stored one")
        except Exception:
            store.record_error()
            self._aot[bucket] = {"status": "error"}
            logger.info("aot: stored bucket %d failed its check; building cold",
                        bucket, exc_info=True)
            self._drop_graph(bucket, spec)
            self._clear_operators()
            return False
        secs = time.perf_counter() - t0
        store.record_hit(secs)
        self._aot[bucket] = {"status": "hit", "load_s": round(secs, 6)}
        return True

    def _save_aot(self, store, key, meta, bucket: int, spec: Any) -> None:
        """After a cold build: keep the bucket's operators and probe
        output, so that the next engine starts from them."""
        try:
            payload = {"operators": self._export_operators(),
                       "output": self._probe(bucket, spec)}
        except Exception:
            store.record_error()
            logger.info("aot: could not take bucket %d's entry", bucket, exc_info=True)
            return
        if store.save(key, payload, meta) is not None:
            if self._aot.get(bucket, {}).get("status") == "error":
                # the report keeps the error visible: a broken entry
                # was replaced, not cleanly created
                self._aot[bucket]["fallback"] = "saved"
            else:
                self._aot[bucket] = {"status": "saved"}

    def aot_report(self) -> Dict[int, Dict[str, Any]]:
        """Per-bucket outcome of the last warmup's store pass (empty
        without a store): ``hit`` (operators from the store, probe equal),
        ``saved`` (built cold, entry written), ``miss`` (no entry, built
        cold), ``error`` (entry corrupt, mismatched or disagreeing, built
        cold; ``fallback: "saved"`` when the cold build replaced it)."""
        return {b: dict(v) for b, v in self._aot.items()}

    __call__ = apply


def _spec_map(fn, spec: Any) -> Any:
    """Map ``fn`` over the (shape, dtype) leaves of a ``_row_spec``."""
    if len(spec) == 2 and isinstance(spec[1], torch.dtype):
        return fn(spec)
    return tuple(_spec_map(fn, s) for s in spec)


def _spec_leaves(spec: Any) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
    if len(spec) == 2 and isinstance(spec[1], torch.dtype):
        return [spec]
    return [leaf for s in spec for leaf in _spec_leaves(s)]


def _tree_to(tree: Any, device) -> Any:
    """Tensors of a stored tree moved to ``device`` (dtype and strides
    kept), containers rebuilt, everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree


def _tree_equal(a: Any, b: Any) -> bool:
    """Bit for bit: the same structure, and every leaf of one dtype and
    shape with the same bytes."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if not (isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor)):
            return False
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        bx = x.contiguous().reshape(-1).view(torch.uint8)
        by = y.contiguous().reshape(-1).view(torch.uint8)
        if not torch.equal(bx, by):
            return False
    return True


def _pool_bytes(graph: Any, device: torch.device) -> int:
    """The bytes of ``graph``'s private memory pool: the allocator's
    segments tagged with its pool id. (A ``memory_reserved`` delta around
    the capture also counts what the capture's own ``empty_cache`` frees,
    and what other threads allocate or free meanwhile.)"""
    pool = tuple(graph.pool())
    index = device.index if device.index is not None else torch.cuda.current_device()
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == index and tuple(seg["segment_pool_id"]) == pool)


def _zip_cat(outs: List[Any]) -> Any:
    """Concatenate chunked outputs leaf by leaf (tuples, and a shared
    prefix's dict of heads)."""
    # `o` is one chunk's output dict or tuple: `o[k]` picks leaf k of
    # each chunk, once per leaf, not per row
    if isinstance(outs[0], dict):
        # lint: disable=hot-path-host-sync
        return {k: _zip_cat([o[k] for o in outs]) for k in outs[0]}
    if isinstance(outs[0], tuple):
        # lint: disable=hot-path-host-sync
        return tuple(_zip_cat([o[i] for o in outs]) for i in range(len(outs[0])))
    return torch.cat(outs, dim=0)
