"""Structural prefix hashing for cross-pipeline memoization.

Reference semantics: workflow/Prefix.scala — a node's Prefix is the structural
identity of its entire upstream subgraph (its operator plus the prefixes of
its dependencies, in order). Two nodes in *different* pipelines that share a
prefix computed the same value, so the executed Expression can be reused
(SavedStateLoadRule). Undefined for nodes with a source ancestor (their value
depends on runtime data).
"""

from __future__ import annotations

from typing import Dict, Optional

from keystone_tpu_torch.workflow.graph import Graph, NodeId, SourceId


class Prefix:
    """Hash-consed structural identity of a node's upstream subgraph."""

    __slots__ = ("op_key", "dep_prefixes", "_hash")

    def __init__(self, op_key, dep_prefixes):
        self.op_key = op_key
        self.dep_prefixes = tuple(dep_prefixes)
        self._hash = hash((op_key, self.dep_prefixes))

    def __eq__(self, other):
        return (
            isinstance(other, Prefix)
            and self._hash == other._hash
            and self.op_key == other.op_key
            and self.dep_prefixes == other.dep_prefixes
        )

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"Prefix({self.op_key!r}, deps={len(self.dep_prefixes)})"


def find_prefix(graph: Graph, node: NodeId) -> Optional[Prefix]:
    """Prefix of ``node``, or None if it depends on any source."""
    memo: Dict[NodeId, Optional[Prefix]] = {}

    def rec(n: NodeId) -> Optional[Prefix]:
        if n in memo:
            return memo[n]
        deps = graph.dependencies[n]
        dep_prefixes = []
        result: Optional[Prefix] = None
        ok = True
        for d in deps:
            if isinstance(d, SourceId):
                ok = False
                break
            dp = rec(d)
            if dp is None:
                ok = False
                break
            dep_prefixes.append(dp)
        if ok:
            result = Prefix(graph.operators[n].eq_key(), dep_prefixes)
        memo[n] = result
        return result

    return rec(node)
