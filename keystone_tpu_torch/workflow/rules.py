"""Catalyst-style rule engine + the structural optimization rules.

Reference semantics: workflow/Rule.scala, RuleExecutor.scala (batches with
Once/FixedPoint strategies), EquivalentNodeMergeRule (CSE),
UnusedBranchRemovalRule (dead-code elimination), ExtractSaveablePrefixes +
SavedStateLoadRule (cross-pipeline prefix memoization).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

from keystone_tpu_torch.workflow.executor import PipelineEnv
from keystone_tpu_torch.workflow.expressions import Expression
from keystone_tpu_torch.workflow.graph import (
    Graph,
    NodeId,
    SinkId,
    get_ancestors,
)
from keystone_tpu_torch.workflow.operators import (
    EstimatorOperator,
    ExpressionOperator,
    Operator,
)
from keystone_tpu_torch.workflow.prefix import Prefix, find_prefix

logger = logging.getLogger(__name__)

PrefixMap = Dict[NodeId, Prefix]


class Rule:
    """Graph -> Graph rewrite, threading the saveable-prefix map through."""

    @property
    def name(self) -> str:
        return type(self).__name__

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        raise NotImplementedError


class Once:
    max_iterations = 1


class FixedPoint:
    def __init__(self, max_iterations: int = 100):
        self.max_iterations = max_iterations


@dataclass
class Batch:
    name: str
    strategy: object
    rules: Sequence[Rule] = field(default_factory=list)


class RuleExecutor:
    """Runs batches of rules to convergence per their strategies."""

    def batches(self) -> List[Batch]:
        raise NotImplementedError

    def execute(self, graph: Graph) -> Tuple[Graph, PrefixMap]:
        prefixes: PrefixMap = {}
        for batch in self.batches():
            iteration = 0
            while iteration < batch.strategy.max_iterations:
                iteration += 1
                before = (graph, dict(prefixes))
                for rule in batch.rules:
                    pre = graph
                    graph, prefixes = rule.apply(graph, prefixes)
                    if logger.isEnabledFor(logging.INFO) and graph != pre:
                        # Per-rule diff logging (reference:
                        # RuleExecutor.scala:44-50 logs a DOT of the plan
                        # after every effective rule application).
                        logger.info(
                            "optimizer batch %r rule %s (iter %d): "
                            "%d -> %d nodes, %d -> %d sources",
                            batch.name,
                            rule.name,
                            iteration,
                            len(pre.operators),
                            len(graph.operators),
                            len(pre.sources),
                            len(graph.sources),
                        )
                        if logger.isEnabledFor(logging.DEBUG):
                            logger.debug(
                                "graph after %s:\n%s",
                                rule.name,
                                graph.to_dot(),
                            )
                if graph == before[0] and prefixes == before[1]:
                    break
            else:
                if not isinstance(batch.strategy, Once):
                    logger.warning(
                        "optimizer batch %r hit max iterations (%d)",
                        batch.name,
                        batch.strategy.max_iterations,
                    )
        return graph, prefixes


class EquivalentNodeMergeRule(Rule):
    """CSE: merge nodes with equal (operator, dependencies).

    Equality of operators is ``Operator.eq_key()`` — shared instances always
    merge; dataclass-keyed operators merge structurally.
    """

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        by_sig: Dict[tuple, List[NodeId]] = {}
        for n in sorted(graph.operators.keys()):
            sig = (graph.operators[n].eq_key(), graph.dependencies[n])
            by_sig.setdefault(sig, []).append(n)
        changed = False
        for sig, group in by_sig.items():
            if len(group) < 2:
                continue
            keep, *drop = group
            for n in drop:
                graph = graph.replace_dependency(n, keep)
                graph = graph.remove_node(n)
                prefixes.pop(n, None)
                changed = True
        if changed:
            # Dep rewrites may expose new merges; FixedPoint re-runs us.
            pass
        return graph, prefixes


class UnusedBranchRemovalRule(Rule):
    """Drop nodes and sources that are not ancestors of any sink."""

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        live: Set = set()
        for k in graph.sink_dependencies:
            live.add(graph.sink_dependencies[k])
            live |= get_ancestors(graph, k)
        dead_nodes = [n for n in graph.operators if n not in live]
        dead_sources = [s for s in graph.sources if s not in live]
        # Remove in reverse-topological order: repeatedly delete unreferenced.
        pending = set(dead_nodes)
        while pending:
            progress = False
            for n in sorted(pending):
                try:
                    graph = graph.remove_node(n)
                except ValueError:
                    continue
                pending.discard(n)
                prefixes.pop(n, None)
                progress = True
                break
            if not progress:
                raise RuntimeError("cycle among dead nodes?")
        for s in dead_sources:
            graph = graph.remove_source(s)
        return graph, prefixes


def _is_saveable_op(op: Operator) -> bool:
    from keystone_tpu_torch.ops.util.cacher import Cacher

    return isinstance(op, (EstimatorOperator, Cacher))


class ExtractSaveablePrefixes(Rule):
    """Compute prefixes for nodes whose results are worth persisting:
    estimator fits and explicit Cacher materialization points."""

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        new = dict(prefixes)
        for n, op in graph.operators.items():
            if _is_saveable_op(op):
                p = find_prefix(graph, n)
                if p is not None:
                    new[n] = p
        return graph, new


class SavedStateLoadRule(Rule):
    """Substitute already-computed expressions for nodes whose prefix is in
    the global state — this makes re-running/refitting pipelines free."""

    def apply(self, graph: Graph, prefixes: PrefixMap) -> Tuple[Graph, PrefixMap]:
        state = PipelineEnv.get_or_create().state
        new_prefixes = dict(prefixes)
        for n, p in list(prefixes.items()):
            if n not in graph.operators:
                continue
            expr = state.get(p)
            if expr is not None and not isinstance(
                graph.operators[n], ExpressionOperator
            ):
                graph = graph.set_operator(n, ExpressionOperator(expr))
                graph = graph.set_dependencies(n, ())
        return graph, new_prefixes
