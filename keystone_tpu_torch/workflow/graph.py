"""Immutable untyped dataflow-graph IR.

The pipeline DAG the optimizer rewrites and the executor interprets. Mirrors
the semantics of KeystoneML's ``src/main/scala/workflow/Graph.scala`` — sources, sinks, nodes
with ordered dependencies, and functional surgery operations — re-expressed as
a frozen Python dataclass over immutable maps. Node payloads are opaque
``Operator`` objects (see operators.py).

Ids are small wrapper types (not raw ints) so that sources, nodes and sinks
can never be confused; a dependency is a ``NodeId | SourceId``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, Mapping, Sequence, Set, Tuple, Union

if TYPE_CHECKING:  # pragma: no cover
    from keystone_tpu_torch.workflow.operators import Operator


@dataclass(frozen=True, order=True)
class NodeId:
    id: int

    def __repr__(self) -> str:
        return f"node{self.id}"


@dataclass(frozen=True, order=True)
class SourceId:
    id: int

    def __repr__(self) -> str:
        return f"source{self.id}"


@dataclass(frozen=True, order=True)
class SinkId:
    id: int

    def __repr__(self) -> str:
        return f"sink{self.id}"


NodeOrSourceId = Union[NodeId, SourceId]
GraphId = Union[NodeId, SourceId, SinkId]


def _max_id(ids: Iterable[int]) -> int:
    m = -1
    for i in ids:
        if i > m:
            m = i
    return m


@dataclass(frozen=True)
class Graph:
    """An immutable DAG of operators.

    - ``sources``: dangling inputs (runtime data gets spliced in here)
    - ``sink_dependencies``: sink -> the node/source whose value it exposes
    - ``operators``: node -> Operator payload
    - ``dependencies``: node -> ordered inputs (nodes or sources)

    All surgery methods return a new Graph (and freshly allocated ids where
    applicable); the receiver is never mutated.
    """

    sources: frozenset  # frozenset[SourceId]
    sink_dependencies: Mapping[SinkId, NodeOrSourceId]
    operators: Mapping[NodeId, "Operator"]
    dependencies: Mapping[NodeId, Tuple[NodeOrSourceId, ...]]

    # -- accessors ---------------------------------------------------------

    @property
    def nodes(self) -> Set[NodeId]:
        return set(self.operators.keys())

    @property
    def sinks(self) -> Set[SinkId]:
        return set(self.sink_dependencies.keys())

    def get_operator(self, node: NodeId) -> "Operator":
        return self.operators[node]

    def get_dependencies(self, node: NodeId) -> Tuple[NodeOrSourceId, ...]:
        return self.dependencies[node]

    def get_sink_dependency(self, sink: SinkId) -> NodeOrSourceId:
        return self.sink_dependencies[sink]

    # -- id allocation -----------------------------------------------------

    def _next_node_id(self) -> NodeId:
        return NodeId(_max_id(n.id for n in self.operators) + 1)

    def _next_source_id(self) -> SourceId:
        return SourceId(_max_id(s.id for s in self.sources) + 1)

    def _next_sink_id(self) -> SinkId:
        return SinkId(_max_id(s.id for s in self.sink_dependencies) + 1)

    # -- surgery -----------------------------------------------------------

    def add_node(
        self, op: "Operator", deps: Sequence[NodeOrSourceId]
    ) -> Tuple["Graph", NodeId]:
        nid = self._next_node_id()
        ops = dict(self.operators)
        ops[nid] = op
        dps = dict(self.dependencies)
        dps[nid] = tuple(deps)
        return dataclasses.replace(self, operators=ops, dependencies=dps), nid

    def add_source(self) -> Tuple["Graph", SourceId]:
        sid = self._next_source_id()
        return dataclasses.replace(self, sources=self.sources | {sid}), sid

    def add_sink(self, dep: NodeOrSourceId) -> Tuple["Graph", SinkId]:
        kid = self._next_sink_id()
        sd = dict(self.sink_dependencies)
        sd[kid] = dep
        return dataclasses.replace(self, sink_dependencies=sd), kid

    def set_dependencies(
        self, node: NodeId, deps: Sequence[NodeOrSourceId]
    ) -> "Graph":
        if node not in self.dependencies:
            raise KeyError(f"{node} not in graph")
        dps = dict(self.dependencies)
        dps[node] = tuple(deps)
        return dataclasses.replace(self, dependencies=dps)

    def set_operator(self, node: NodeId, op: "Operator") -> "Graph":
        if node not in self.operators:
            raise KeyError(f"{node} not in graph")
        ops = dict(self.operators)
        ops[node] = op
        return dataclasses.replace(self, operators=ops)

    def set_sink_dependency(self, sink: SinkId, dep: NodeOrSourceId) -> "Graph":
        if sink not in self.sink_dependencies:
            raise KeyError(f"{sink} not in graph")
        sd = dict(self.sink_dependencies)
        sd[sink] = dep
        return dataclasses.replace(self, sink_dependencies=sd)

    def remove_sink(self, sink: SinkId) -> "Graph":
        sd = dict(self.sink_dependencies)
        del sd[sink]
        return dataclasses.replace(self, sink_dependencies=sd)

    def remove_source(self, source: SourceId) -> "Graph":
        """Remove a source. Fails if anything still depends on it."""
        self._check_unreferenced(source)
        return dataclasses.replace(self, sources=self.sources - {source})

    def remove_node(self, node: NodeId) -> "Graph":
        """Remove a node. Fails if anything still depends on it."""
        self._check_unreferenced(node)
        ops = dict(self.operators)
        del ops[node]
        dps = dict(self.dependencies)
        del dps[node]
        return dataclasses.replace(self, operators=ops, dependencies=dps)

    def _check_unreferenced(self, target: NodeOrSourceId) -> None:
        for n, deps in self.dependencies.items():
            if target in deps:
                raise ValueError(f"{target} still referenced by {n}")
        for k, dep in self.sink_dependencies.items():
            if dep == target:
                raise ValueError(f"{target} still referenced by {k}")

    def replace_dependency(
        self, old: NodeOrSourceId, new: NodeOrSourceId
    ) -> "Graph":
        """Rewrite every dependency (node & sink) on ``old`` to ``new``."""
        dps = {
            n: tuple(new if d == old else d for d in deps)
            for n, deps in self.dependencies.items()
        }
        sd = {
            k: (new if d == old else d)
            for k, d in self.sink_dependencies.items()
        }
        return dataclasses.replace(self, dependencies=dps, sink_dependencies=sd)

    # -- whole-graph composition ------------------------------------------

    def add_graph(
        self, other: "Graph"
    ) -> Tuple["Graph", Dict[SourceId, SourceId], Dict[SinkId, SinkId]]:
        """Disjoint union: import ``other`` with freshly re-numbered ids.

        Returns (new graph, other-source -> new-source map,
        other-sink -> new-sink map).
        """
        node_base = _max_id(n.id for n in self.operators) + 1
        source_base = _max_id(s.id for s in self.sources) + 1
        sink_base = _max_id(s.id for s in self.sink_dependencies) + 1

        node_map = {
            n: NodeId(node_base + i)
            for i, n in enumerate(sorted(other.operators.keys()))
        }
        source_map = {
            s: SourceId(source_base + i)
            for i, s in enumerate(sorted(other.sources))
        }
        sink_map = {
            s: SinkId(sink_base + i)
            for i, s in enumerate(sorted(other.sink_dependencies.keys()))
        }

        def remap(d: NodeOrSourceId) -> NodeOrSourceId:
            return node_map[d] if isinstance(d, NodeId) else source_map[d]

        ops = dict(self.operators)
        dps = dict(self.dependencies)
        for n, op in other.operators.items():
            ops[node_map[n]] = op
            dps[node_map[n]] = tuple(remap(d) for d in other.dependencies[n])
        sd = dict(self.sink_dependencies)
        for k, d in other.sink_dependencies.items():
            sd[sink_map[k]] = remap(d)

        g = Graph(
            sources=self.sources | frozenset(source_map.values()),
            sink_dependencies=sd,
            operators=ops,
            dependencies=dps,
        )
        return g, source_map, sink_map

    def connect_graph(
        self, other: "Graph", splice: Mapping[SourceId, SinkId]
    ) -> Tuple["Graph", Dict[SourceId, SourceId], Dict[SinkId, SinkId]]:
        """Import ``other`` and splice: for (src -> snk) in ``splice``,
        other's source ``src`` is replaced by whatever this graph's sink
        ``snk`` points at; both the source and the sink are removed.

        Returns (graph, source map for other's *unspliced* sources, sink map
        for other's sinks).
        """
        g, source_map, sink_map = self.add_graph(other)
        for other_src, self_snk in splice.items():
            new_src = source_map[other_src]
            target = self.sink_dependencies[self_snk]
            g = g.replace_dependency(new_src, target)
            g = g.remove_source(new_src)
            g = g.remove_sink(self_snk)
            del source_map[other_src]
        return g, source_map, sink_map

    def replace_nodes(
        self,
        nodes_to_remove: Set[NodeId],
        replacement: "Graph",
        replacement_source_splice: Mapping[SourceId, NodeOrSourceId],
        replacement_sink_splice: Mapping[NodeId, SinkId],
    ) -> "Graph":
        """Swap a node subset for a replacement subgraph.

        ``replacement_source_splice``: replacement source -> existing
        node/source feeding it. ``replacement_sink_splice``: removed node ->
        replacement sink standing in for it (all outside edges onto the
        removed node are rerouted to the sink's dependency).
        """
        g, source_map, sink_map = self.add_graph(replacement)
        # Reroute edges onto removed nodes to the replacement sinks' targets.
        for removed, rsink in replacement_sink_splice.items():
            new_sink = sink_map[rsink]
            target = g.sink_dependencies[new_sink]
            g = g.replace_dependency(removed, target)
        # Splice replacement sources onto existing feeders.
        for rsource, feeder in replacement_source_splice.items():
            new_src = source_map[rsource]
            g = g.replace_dependency(new_src, feeder)
            g = g.remove_source(new_src)
        # Drop the imported replacement sinks.
        for rsink in replacement_sink_splice.values():
            g = g.remove_sink(sink_map[rsink])
        # Remove the dead nodes (dependents first is unnecessary: all
        # references were rerouted above).
        for n in nodes_to_remove:
            g = g.remove_node(n)
        return g

    # -- introspection -----------------------------------------------------

    def to_dot(self, name: str = "pipeline") -> str:
        """Graphviz export (reference: Graph.toDOTString)."""
        lines = [f"digraph {name} {{", "  rankdir=LR;"]
        for s in sorted(self.sources):
            lines.append(f'  "{s!r}" [shape=oval, style=dashed];')
        for n in sorted(self.operators):
            label = getattr(self.operators[n], "label", None) or type(
                self.operators[n]
            ).__name__
            lines.append(f'  "{n!r}" [shape=box, label="{label}"];')
        for k in sorted(self.sink_dependencies):
            lines.append(f'  "{k!r}" [shape=oval, style=bold];')
        for n, deps in sorted(self.dependencies.items()):
            for i, d in enumerate(deps):
                lines.append(f'  "{d!r}" -> "{n!r}" [label="{i}"];')
        for k, d in sorted(self.sink_dependencies.items()):
            lines.append(f'  "{d!r}" -> "{k!r}";')
        lines.append("}")
        return "\n".join(lines)


EMPTY_GRAPH = Graph(
    sources=frozenset(), sink_dependencies={}, operators={}, dependencies={}
)


# -- analyses (reference: workflow/AnalysisUtils.scala) ---------------------


def get_parents(graph: Graph, gid: GraphId) -> Set[NodeOrSourceId]:
    if isinstance(gid, SinkId):
        return {graph.sink_dependencies[gid]}
    if isinstance(gid, SourceId):
        return set()
    return set(graph.dependencies[gid])


def get_ancestors(graph: Graph, gid: GraphId) -> Set[NodeOrSourceId]:
    seen: Set[NodeOrSourceId] = set()
    stack = list(get_parents(graph, gid))
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(get_parents(graph, cur))
    return seen


def get_children(graph: Graph, gid: NodeOrSourceId) -> Set[GraphId]:
    out: Set[GraphId] = set()
    for n, deps in graph.dependencies.items():
        if gid in deps:
            out.add(n)
    for k, d in graph.sink_dependencies.items():
        if d == gid:
            out.add(k)
    return out


def get_descendants(graph: Graph, gid: NodeOrSourceId) -> Set[GraphId]:
    seen: Set[GraphId] = set()
    stack = list(get_children(graph, gid))
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        if not isinstance(cur, SinkId):
            stack.extend(get_children(graph, cur))
    return seen


def linearize(graph: Graph) -> Tuple[GraphId, ...]:
    """Deterministic topological order over sources, nodes, then sinks.

    Depth-first from each sink in sorted order (reference:
    AnalysisUtils.linearize) so equal graphs linearize identically.
    """
    order: list = []
    seen: Set[GraphId] = set()

    def visit(gid: GraphId) -> None:
        if gid in seen:
            return
        seen.add(gid)
        for p in sorted(get_parents(graph, gid), key=_id_sort_key):
            visit(p)
        order.append(gid)

    for k in sorted(graph.sink_dependencies.keys()):
        visit(k)
    return tuple(order)


def _id_sort_key(gid: GraphId) -> Tuple[int, int]:
    kind = 0 if isinstance(gid, SourceId) else (1 if isinstance(gid, NodeId) else 2)
    return (kind, gid.id)
