"""Default optimizer pipelines.

Reference semantics: workflow/DefaultOptimizer.scala — batches:
(1) load saved state (extract saveable prefixes, substitute saved results,
    prune the now-dead branches), once;
(2) common-subexpression elimination, fixed point;
(3) cost-based physical node optimization, once.
``AutoCachingOptimizer`` appends profile-driven cache insertion.
"""

from __future__ import annotations

from typing import List

from keystone_tpu_torch.workflow.rules import (
    Batch,
    EquivalentNodeMergeRule,
    ExtractSaveablePrefixes,
    FixedPoint,
    Once,
    RuleExecutor,
    SavedStateLoadRule,
    UnusedBranchRemovalRule,
)


class DefaultOptimizer(RuleExecutor):
    def batches(self) -> List[Batch]:
        from keystone_tpu_torch.workflow.node_optimization import NodeOptimizationRule

        return [
            Batch(
                "Load Saved State",
                Once(),
                [
                    ExtractSaveablePrefixes(),
                    SavedStateLoadRule(),
                    UnusedBranchRemovalRule(),
                ],
            ),
            Batch(
                "Common Sub-expression Elimination",
                FixedPoint(100),
                [EquivalentNodeMergeRule()],
            ),
            Batch("Node Level Optimization", Once(), [NodeOptimizationRule()]),
        ]


class AutoCachingOptimizer(RuleExecutor):
    """``DefaultOptimizer`` and then profile-driven cache insertion
    (``workflow/auto_cache.py``), ``strategy`` "greedy" or "aggressive"."""

    def __init__(self, strategy: str = "greedy", mem_budget_bytes: int = None):
        self.strategy = strategy
        self.mem_budget_bytes = mem_budget_bytes

    def batches(self) -> List[Batch]:
        from keystone_tpu_torch.workflow.auto_cache import AutoCacheRule

        return DefaultOptimizer().batches() + [
            Batch("Auto Cache", Once(), [AutoCacheRule(self.strategy, self.mem_budget_bytes)])
        ]
