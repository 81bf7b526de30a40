"""Memoizing graph executor + process-global pipeline environment.

Reference semantics: workflow/GraphExecutor.scala (memoized recursive
interpretation, optimize-once-lazily, refuse to execute source-dependent ids,
save executed prefixes into the global state) and workflow/PipelineEnv.scala
(process singleton holding cross-pipeline prefix state and the optimizer).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from keystone_tpu_torch.observability.tracing import get_tracer
from keystone_tpu_torch.workflow.expressions import Expression
from keystone_tpu_torch.workflow.graph import (
    Graph,
    GraphId,
    NodeId,
    SinkId,
    SourceId,
    get_ancestors,
)
from keystone_tpu_torch.workflow.prefix import Prefix


class _Leaf(NamedTuple):
    """One leaf of a saved dataset: ``raw`` (pickled as it is), ``arr`` (a
    numpy array in the index) or ``npy`` (the name of its own file)."""

    kind: str
    payload: Any


class PipelineEnv:
    """Process-global: prefix-keyed saved state + the active optimizer."""

    _instance: Optional["PipelineEnv"] = None

    def __init__(self):
        self.state: Dict[Prefix, Expression] = {}
        self._optimizer = None

    @classmethod
    def get_or_create(cls) -> "PipelineEnv":
        if cls._instance is None:
            cls._instance = PipelineEnv()
        return cls._instance

    @property
    def optimizer(self):
        if self._optimizer is None:
            from keystone_tpu_torch.workflow.optimizer import DefaultOptimizer

            self._optimizer = DefaultOptimizer()
        return self._optimizer

    @optimizer.setter
    def optimizer(self, opt) -> None:
        self._optimizer = opt

    def reset(self) -> None:
        self.state = {}
        self._optimizer = None

    # -- persistence (the prefix state is a content-addressed cache keyed
    # by structural prefix; persisting it lets re-built pipelines in a NEW
    # process skip recompute) ----------------------------------------------

    def save_state(
        self,
        path: str,
        *,
        large_array_bytes: int = 1 << 20,
        max_total_bytes: Optional[int] = None,
    ) -> None:
        """Persist every materialized prefix expression to a directory:
        ``index.pt`` plus one ``.npy`` file per large tensor.

        Tensors of ``large_array_bytes`` or more stream to their own file
        one at a time (device -> host -> disk, then released), so a cached
        feature dataset never needs the whole state on the host at once.
        ``max_total_bytes`` caps what gets written: an entry that would
        exceed the budget is skipped whole (its files removed and
        un-charged), in state-iteration order. Unevaluated expressions are
        skipped, not forced."""
        import os
        import pickle

        from keystone_tpu_torch.parallel.dataset import Dataset

        os.makedirs(path, exist_ok=True)
        index = {}
        written = 0
        counter = 0

        def persist_tree(tree):
            """The tree with large tensors replaced by ``.npy`` file
            references, or None (files and budget rolled back) if the
            entry would exceed the budget."""
            nonlocal counter, written
            entry_files = []
            entry_bytes = 0

            def rollback():
                nonlocal written
                for f in entry_files:
                    try:
                        os.remove(os.path.join(path, f))
                    except OSError:
                        pass
                written -= entry_bytes

            def persist(leaf):
                nonlocal counter, written, entry_bytes
                if isinstance(leaf, (tuple, list)):
                    out = [persist(x) for x in leaf]
                    return None if any(o is None for o in out) else (
                        tuple(out) if isinstance(leaf, tuple) else out)
                if not isinstance(leaf, (torch.Tensor, np.ndarray)):
                    return _Leaf("raw", leaf)
                a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else leaf
                if max_total_bytes is not None and written + a.nbytes > max_total_bytes:
                    return None
                written += a.nbytes
                entry_bytes += a.nbytes
                if a.nbytes >= large_array_bytes:
                    fname = f"arr{counter:05d}.npy"
                    counter += 1
                    np.save(os.path.join(path, fname), a)
                    entry_files.append(fname)
                    return _Leaf("npy", fname)
                return _Leaf("arr", a)

            out = persist(tree)
            if out is None:
                rollback()
            return out

        for prefix, expr in self.state.items():
            if not expr.is_computed:
                continue
            value = expr.get()
            if isinstance(value, Dataset):
                if value.is_array:
                    tree = persist_tree(value.padded())
                    entry = ("dataset_array", tree, value.n)
                else:
                    tree = persist_tree(value.items())
                    entry = ("dataset_items", tree, None)
                if tree is None:
                    continue
            else:
                entry = ("raw", value, None)
            try:
                pickle.dumps(entry)
                pickle.dumps(prefix)
            except Exception:
                continue  # unpicklable (e.g. a closure-defined transformer)
            index[prefix] = entry
        torch.save(index, os.path.join(path, "index.pt"))

    def load_state(self, path: str, device=None) -> int:
        """Load persisted prefix state, every tensor on ``device`` (``None``
        means ``cuda``, raising without it); returns the number of
        entries. This unpickles ``index.pt``: load only state you trust."""
        import os

        from keystone_tpu_torch._device import resolve_device
        from keystone_tpu_torch.parallel.dataset import Dataset
        from keystone_tpu_torch.workflow.expressions import (
            DatasetExpression,
            DatumExpression,
        )

        dev = resolve_device(device)
        saved = torch.load(os.path.join(path, "index.pt"), map_location=dev,
                           weights_only=False)

        def restore(tree):
            if isinstance(tree, _Leaf):
                if tree.kind == "raw":
                    return tree.payload
                a = tree.payload
                if tree.kind == "npy":
                    a = np.load(os.path.join(path, a))
                return torch.as_tensor(a).to(dev)
            if isinstance(tree, list):
                return [restore(x) for x in tree]
            return tuple(restore(x) for x in tree)

        for prefix, (kind, payload, n) in saved.items():
            if kind == "dataset_array":
                ds = Dataset.from_array(restore(payload), n=n)
                self.state[prefix] = DatasetExpression.of(ds)
            elif kind == "dataset_items":
                ds = Dataset.from_items(restore(payload))
                self.state[prefix] = DatasetExpression.of(ds)
            else:
                self.state[prefix] = DatumExpression.of(payload)
        return len(saved)


class GraphExecutor:
    """Executes a graph, memoizing per-id expressions.

    ``optimize=True`` runs the environment's optimizer once, lazily, before
    the first execution. Ids with a source ancestor cannot be executed (their
    value depends on unspliced runtime data).

    Observability: ``node_hook`` is an optional
    ``callable(node_id, label, seconds)`` invoked with each node's own
    operator-execution wall time (excluding dependency time) the first
    time the node runs — ``utils.profiling.instrument_executor`` sets it.
    Independently, when the process-global tracer
    (``observability.tracing``) is enabled, every first-time node
    evaluation records a ``node:<label>`` span whose parent is the span
    of the consumer that demanded it, so ``/tracez`` shows the executed
    DAG as a span tree. Both are off by default and cost one attribute
    check per node when off.
    """

    def __init__(
        self,
        graph: Graph,
        optimize: bool = True,
        node_hook: Optional[Callable[[GraphId, str, float], None]] = None,
    ):
        self._raw_graph = graph
        self._optimize = optimize
        self._optimized: Optional[Tuple[Graph, Dict[NodeId, Prefix]]] = None
        self._execution_state: Dict[GraphId, Expression] = {}
        self._source_dependants: Optional[Set[GraphId]] = None
        self.node_hook = node_hook

    @property
    def raw_graph(self) -> Graph:
        return self._raw_graph

    @property
    def graph(self) -> Graph:
        return self._optimized_graph_and_prefixes()[0]

    @property
    def prefixes(self) -> Dict[NodeId, Prefix]:
        return self._optimized_graph_and_prefixes()[1]

    def _optimized_graph_and_prefixes(self):
        if self._optimized is None:
            if self._optimize:
                env = PipelineEnv.get_or_create()
                self._optimized = env.optimizer.execute(self._raw_graph)
            else:
                self._optimized = (self._raw_graph, {})
        return self._optimized

    def _unexecutable(self) -> Set[GraphId]:
        if self._source_dependants is None:
            g = self.graph
            bad: Set[GraphId] = set(g.sources)
            for s in g.sources:
                from keystone_tpu_torch.workflow.graph import get_descendants

                bad |= get_descendants(g, s)
            self._source_dependants = bad
        return self._source_dependants

    def execute(self, graph_id: GraphId) -> Expression:
        if graph_id in self._unexecutable():
            raise ValueError(
                f"{graph_id} depends on an unconnected source; splice data in "
                "with pipeline.apply(...) before executing"
            )
        if graph_id in self._execution_state:
            return self._execution_state[graph_id]

        g, prefixes = self._optimized_graph_and_prefixes()
        if isinstance(graph_id, SourceId):
            raise ValueError(f"cannot execute source {graph_id}")
        if isinstance(graph_id, SinkId):
            expr = self.execute(g.sink_dependencies[graph_id])
        else:
            tracer = get_tracer()
            if tracer.enabled or self.node_hook is not None:
                expr = self._execute_instrumented(graph_id, g, tracer)
            else:
                dep_exprs = [
                    self.execute(d) for d in g.dependencies[graph_id]
                ]
                expr = g.operators[graph_id].execute(dep_exprs)
            # Cross-pipeline prefix memoization (GraphExecutor.scala:68-70):
            # expose this node's expression under its structural prefix.
            prefix = prefixes.get(graph_id)
            if prefix is not None:
                PipelineEnv.get_or_create().state.setdefault(prefix, expr)
        self._execution_state[graph_id] = expr
        return expr

    def _execute_instrumented(self, graph_id, g, tracer) -> Expression:
        """First-time node evaluation with a ``node:<label>`` span around
        the whole demand (so dependency spans nest under their consumer,
        mirroring the executed DAG in ``/tracez``) and the node's OWN
        operator wall time — dependencies excluded — reported to
        ``node_hook`` and stamped on the span."""
        op = g.operators[graph_id]
        label = getattr(op, "label", type(op).__name__)
        with tracer.span(f"node:{label}", node_id=str(graph_id)) as span:
            dep_exprs = [self.execute(d) for d in g.dependencies[graph_id]]
            t0 = time.perf_counter()
            expr = op.execute(dep_exprs)
            self_seconds = time.perf_counter() - t0
            span.set_attr("self_ms", round(self_seconds * 1e3, 6))
        if self.node_hook is not None:
            self.node_hook(graph_id, label, self_seconds)
        return expr
