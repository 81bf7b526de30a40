"""Typed user-facing pipeline API.

Counterpart of ``keystone_tpu/workflow/api.py``:

- ``Transformer.apply(x)`` is a function on one example; ``apply_batch(ds)``
  is the batched path over the dataset's leading example axis. Every node
  on the serving path writes its own ``apply_batch``, because a CUDA kernel
  called through ``ctypes`` cannot run under ``torch.func.vmap``; the
  default ``apply_batch`` (for small user nodes) maps ``apply`` with
  ``vmap`` in array mode and on the host in items mode.
- ``Pipeline.fit()`` executes estimator fits (memoized by structural prefix
  across pipelines) and returns a ``FittedPipeline``. PyTorch runs eagerly,
  so there is no ``jit``: ``FittedPipeline._batch_run`` is the batched
  apply path the serving engine dispatches.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Sequence, Union

import numpy as np
import torch

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.executor import GraphExecutor
from keystone_tpu_torch.workflow.graph import (
    EMPTY_GRAPH,
    Graph,
    NodeId,
    SinkId,
    SourceId,
    linearize,
)
from keystone_tpu_torch.workflow.operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    TransformerOperator,
)
from keystone_tpu_torch.workflow.rules import UnusedBranchRemovalRule


def _array_digest(a: np.ndarray) -> Any:
    """Fixed-size fingerprint of an array's contents, so CSE/prefix keys
    don't scale with parameter bytes."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return ("arr", a.shape, str(a.dtype), h.hexdigest())


def _hashable(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return _array_digest(v)
    if isinstance(v, torch.Tensor):
        return _array_digest(v.detach().cpu().numpy())
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    try:
        hash(v)
        return v
    except TypeError:
        return id(v)


def _cached_hashable(self, v: Any) -> Any:
    """_hashable with the array digest memoized per (instance, tensor
    identity). A node's tensors are frozen parameters — nothing in the
    port updates them in place — so identity is a sound cache key for
    them, as it is for immutable ``jax.Array``s in the JAX package.
    Writeable numpy arrays are digested fresh on each call."""
    if isinstance(v, torch.Tensor) or (
        isinstance(v, np.ndarray) and not v.flags.writeable
    ):
        cache = self.__dict__.setdefault("_arr_digest_cache", {})
        hit = cache.get(id(v))
        if hit is None:
            hit = _hashable(v)
            cache[id(v)] = hit
            # hold a reference so id() can't be recycled
            cache[(id(v), "ref")] = v
        return hit
    if isinstance(v, np.ndarray):
        return _hashable(v)
    if isinstance(v, (list, tuple)):
        return tuple(_cached_hashable(self, x) for x in v)
    if isinstance(v, dict):
        return tuple(
            sorted((k, _cached_hashable(self, x)) for k, x in v.items())
        )
    return _hashable(v)


def _dataclass_eq_key(self) -> Any:
    """Structural key for dataclass operators (CSE equality)."""
    if not dataclasses.is_dataclass(self):
        return id(self)
    return (
        type(self),
        tuple(
            (f.name, _cached_hashable(self, getattr(self, f.name)))
            for f in dataclasses.fields(self)
        ),
    )


class Chainable:
    """Anything composable into a pipeline via ``and_then``."""

    def to_pipeline(self) -> "Pipeline":
        raise NotImplementedError

    def and_then(
        self, nxt: Union["Chainable", "Estimator"], data: Any = None
    ) -> "Pipeline":
        pipe = self.to_pipeline()
        if isinstance(nxt, Estimator):
            if data is None:
                raise TypeError("Estimator chaining needs data")
            return pipe._concat(nxt.with_data(pipe(data)))
        return pipe._concat(nxt.to_pipeline())

    def __call__(self, data: Any) -> "PipelineResult":
        return self.to_pipeline().apply(data)

    def apply(self, data: Any) -> "PipelineResult":
        return self.to_pipeline().apply(data)


class Pipeline(Chainable):
    """A (GraphExecutor, source, sink) triple — one dangling input, one
    output. Applying data splices it in place of the source; execution stays
    lazy until ``PipelineResult.get()``."""

    def __init__(self, executor: GraphExecutor, source: SourceId, sink: SinkId):
        self.executor = executor
        self.source = source
        self.sink = sink

    @property
    def _graph(self) -> Graph:
        return self.executor.raw_graph

    def to_pipeline(self) -> "Pipeline":
        return self

    def _concat(self, nxt: "Pipeline") -> "Pipeline":
        g, _, sink_map = self._graph.connect_graph(
            nxt._graph, {nxt.source: self.sink}
        )
        return Pipeline(GraphExecutor(g), self.source, sink_map[nxt.sink])

    def apply(self, data: Any) -> "PipelineResult":
        if isinstance(data, PipelineDataset):
            g, _, sink_map = data._graph.connect_graph(
                self._graph, {self.source: data._sink}
            )
            return PipelineDataset(GraphExecutor(g), sink_map[self.sink])
        if isinstance(data, PipelineDatum):
            g, _, sink_map = data._graph.connect_graph(
                self._graph, {self.source: data._sink}
            )
            return PipelineDatum(GraphExecutor(g), sink_map[self.sink])
        if isinstance(data, (Dataset, list)) or (
            hasattr(data, "ndim") and data.ndim >= 2
        ):
            return self.apply(PipelineDataset.of(Dataset.of(data)))
        return self.apply_datum(data)

    def apply_datum(self, datum: Any) -> "PipelineDatum":
        g, nid = self._graph.add_node(DatumOperator(datum), ())
        g = g.replace_dependency(self.source, nid)
        g = g.remove_source(self.source)
        return PipelineDatum(GraphExecutor(g), self.sink)

    def fit(self) -> "FittedPipeline":
        """Execute every estimator fit (prefix-memoized), swap delegating
        nodes for the fit transformers, prune, freeze."""
        executor = self.executor
        g = executor.graph  # optimized
        for n in sorted(g.operators.keys()):
            if isinstance(g.operators[n], DelegatingOperator):
                deps = g.dependencies[n]
                fit_transformer = executor.execute(deps[0]).get()
                if not isinstance(fit_transformer, TransformerOperator):
                    raise TypeError(
                        f"estimator fit returned {type(fit_transformer)}"
                    )
                g = g.set_operator(n, fit_transformer)
                g = g.set_dependencies(n, deps[1:])
        g_pruned, _ = UnusedBranchRemovalRule().apply(
            Graph(
                sources=g.sources,
                sink_dependencies={self.sink: g.sink_dependencies[self.sink]},
                operators=g.operators,
                dependencies=g.dependencies,
            ),
            {},
        )
        for n, op in g_pruned.operators.items():
            if not isinstance(op, TransformerOperator):
                raise TypeError(
                    f"fit pipeline contains non-transformer node {n}: {op!r}"
                )
        return FittedPipeline(g_pruned, self.source, self.sink)

    @staticmethod
    def gather(branches: Sequence[Chainable]) -> "Pipeline":
        """Merge N single-input branches onto one shared source; output per
        example is the tuple of branch outputs."""
        g, src = EMPTY_GRAPH.add_source()
        ends: List = []
        for branch in branches:
            bp = branch.to_pipeline()
            g, smap, kmap = g.add_graph(bp._graph)
            g = g.replace_dependency(smap[bp.source], src)
            g = g.remove_source(smap[bp.source])
            end = g.sink_dependencies[kmap[bp.sink]]
            g = g.remove_sink(kmap[bp.sink])
            ends.append(end)
        g, gather_node = g.add_node(GatherTransformerOperator(), ends)
        g, sink = g.add_sink(gather_node)
        return Pipeline(GraphExecutor(g), src, sink)


class PipelineResult:
    """Lazily executed sink value."""

    def __init__(self, executor: GraphExecutor, sink: SinkId):
        self._executor = executor
        self._sink = sink
        self._result: Any = None
        self._done = False

    @property
    def _graph(self) -> Graph:
        return self._executor.raw_graph

    def get(self) -> Any:
        if not self._done:
            self._result = self._executor.execute(self._sink).get()
            self._done = True
        return self._result


class PipelineDataset(PipelineResult):
    @staticmethod
    def of(dataset: Dataset) -> "PipelineDataset":
        g, nid = EMPTY_GRAPH.add_node(DatasetOperator(dataset), ())
        g, sink = g.add_sink(nid)
        return PipelineDataset(GraphExecutor(g), sink)


class PipelineDatum(PipelineResult):
    pass


class Transformer(Chainable, TransformerOperator):
    """A per-example function, liftable to a one-node pipeline.

    Subclasses override ``apply(x)`` and, on the serving path, the batched
    ``apply_batch(ds)``."""

    def apply(self, x: Any) -> Any:  # single datum
        raise NotImplementedError

    def apply_batch(self, ds: Dataset) -> Dataset:
        if ds.is_array:
            return Dataset.from_array(
                torch.func.vmap(self.apply)(ds.padded()), n=ds.n
            )
        return ds.map(self.apply)

    def single_transform(self, inputs: Sequence[Any]) -> Any:
        return self.apply(inputs[0])

    def batch_transform(self, inputs: Sequence[Dataset]) -> Dataset:
        return self.apply_batch(inputs[0])

    def to_pipeline(self) -> Pipeline:
        g, src = EMPTY_GRAPH.add_source()
        g, nid = g.add_node(self, (src,))
        g, sink = g.add_sink(nid)
        return Pipeline(GraphExecutor(g), src, sink)

    def __call__(self, data: Any) -> Any:
        return self.to_pipeline().apply(data)

    def eq_key(self) -> Any:
        return _dataclass_eq_key(self)

    @property
    def label(self) -> str:  # type: ignore[override]
        return type(self).__name__


class Estimator(Chainable, EstimatorOperator):
    """fit(Dataset) -> Transformer; splice-able into a pipeline."""

    def fit(self, data: Dataset) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, datasets: Sequence[Dataset]) -> TransformerOperator:
        return self.fit(datasets[0])

    def with_data(self, data: Any) -> Pipeline:
        g, data_end = _splice_data(EMPTY_GRAPH, data)
        g, est_node = g.add_node(self, (data_end,))
        g, src = g.add_source()
        g, delegate = g.add_node(DelegatingOperator(), (est_node, src))
        g, sink = g.add_sink(delegate)
        return Pipeline(GraphExecutor(g), src, sink)

    def to_pipeline(self) -> Pipeline:
        raise TypeError(
            "an Estimator is not directly chainable; use and_then(est, data)"
        )

    def eq_key(self) -> Any:
        return _dataclass_eq_key(self)

    @property
    def label(self) -> str:  # type: ignore[override]
        return type(self).__name__


def _splice_data(g: Graph, data: Any):
    """Attach a data producer to ``g``: a constant dataset node, or the whole
    upstream graph of a PipelineDataset (so shared prefixes stay shared)."""
    if isinstance(data, PipelineResult):
        if data._graph.sources:
            raise ValueError("cannot splice a pipeline with dangling sources")
        g2, _, kmap = g.add_graph(data._graph)
        end = g2.sink_dependencies[kmap[data._sink]]
        g2 = g2.remove_sink(kmap[data._sink])
        return g2, end
    return g.add_node(DatasetOperator(Dataset.of(data)), ())


class GatherTransformerOperator(TransformerOperator):
    """Zips N branch outputs into a per-example tuple."""

    label = "gather"

    def single_transform(self, inputs: Sequence[Any]) -> Any:
        return tuple(inputs)

    def batch_transform(self, inputs: Sequence[Dataset]) -> Dataset:
        n = inputs[0].n
        if any(ds.n != n for ds in inputs):
            raise ValueError("gather branches disagree on dataset length")
        if all(ds.is_array for ds in inputs):
            pn = max(ds.padded_n for ds in inputs)
            arrs = tuple(ds._pad_to(pn).padded() for ds in inputs)
            return Dataset.from_array(arrs, n=n)
        cols = [ds.items() for ds in inputs]
        return Dataset.from_items([tuple(row) for row in zip(*cols)])

    def eq_key(self) -> Any:
        return ("gather",)


class FittedPipeline:
    """A train-free, transformer-only pipeline. ``apply`` interprets the
    graph node by node; ``compiled()`` puts it behind the bucketed serving
    engine."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        self.graph = graph
        self.source = source
        self.sink = sink
        self._topo = [
            gid for gid in linearize(graph) if isinstance(gid, NodeId)
        ]

    def _run(self, feed: Any, batch: bool) -> Any:
        values: Dict[Any, Any] = {self.source: feed}
        for n in self._topo:
            op = self.graph.operators[n]
            ins = [values[d] for d in self.graph.dependencies[n]]
            if batch:
                values[n] = op.batch_transform(ins)
            else:
                values[n] = op.single_transform(ins)
        return values[self.graph.sink_dependencies[self.sink]]

    def apply(self, data: Any) -> Any:
        if isinstance(data, PipelineResult):
            data = data.get()
        if isinstance(data, Dataset):
            return self._run(data, batch=True)
        return self._run(data, batch=False)

    __call__ = apply

    def _batch_run(self, arr: Any) -> Any:
        """The whole-batch apply path: tensor(s) in, tensor(s) out — the
        surface the serving engine dispatches. Rows past the valid count
        are zeros by the Dataset pad discipline; callers slice outputs back
        to their valid rows."""
        out = self._run(Dataset.from_array(arr), batch=True)
        return out.padded() if isinstance(out, Dataset) else out

    def compiled(self, buckets=None, *, featurize=None, device=None, name=None):
        """This pipeline behind the bucketed serving engine
        (``serving/engine.py`` ``CompiledPipeline``). ``device=None``
        means ``cuda``."""
        from keystone_tpu_torch.serving.engine import (
            DEFAULT_BUCKETS,
            CompiledPipeline,
        )

        return CompiledPipeline(
            self, buckets if buckets is not None else DEFAULT_BUCKETS,
            featurize=featurize, device=device, name=name,
        )
