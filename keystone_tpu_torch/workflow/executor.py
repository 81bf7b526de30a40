"""Memoizing graph executor + process-global pipeline environment.

Reference semantics: workflow/GraphExecutor.scala (memoized recursive
interpretation, optimize-once-lazily, refuse to execute source-dependent ids,
save executed prefixes into the global state) and workflow/PipelineEnv.scala
(process singleton holding cross-pipeline prefix state and the optimizer).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Set, Tuple

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
