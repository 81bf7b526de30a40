"""Merge predictions over augmented copies of each example.

Reference: evaluation/AugmentedExamplesEvaluator.scala:9 — group the
augmented copies by source image id, combine per-class scores by averaging
(or Borda rank counting), then evaluate multiclass metrics on the merged
predictions (counterpart of ``keystone_tpu/evaluation/augmented.py``).
"""

from __future__ import annotations

import enum
from typing import Any, Sequence

import numpy as np

from keystone_tpu_torch.evaluation.multiclass import (
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
    host_array,
)


class AggregationPolicy(enum.Enum):
    average = "average"
    borda = "borda"


class AugmentedExamplesEvaluator:
    def __init__(
        self,
        names: Sequence[Any],
        num_classes: int,
        policy: AggregationPolicy = AggregationPolicy.average,
    ):
        self.names = list(names)
        self.num_classes = num_classes
        self.policy = policy

    def evaluate(self, scores: Any, labels: Any) -> MulticlassMetrics:
        """``scores``: (n_augmented, classes); ``labels``: (n_augmented,)
        int class ids; ``self.names[i]`` identifies the source example of
        augmented row i."""
        scores = host_array(scores)
        labels = host_array(labels).reshape(-1)

        by_name: dict = {}
        for i, name in enumerate(self.names):
            by_name.setdefault(name, []).append(i)

        merged_preds, merged_labels = [], []
        for name, idxs in by_name.items():
            s = scores[idxs]
            if self.policy is AggregationPolicy.average:
                combined = s.mean(axis=0)
            else:  # borda: sum of per-copy ranks
                combined = np.argsort(np.argsort(s, axis=1), axis=1).sum(axis=0)
            merged_preds.append(int(np.argmax(combined)))
            merged_labels.append(int(labels[idxs[0]]))
        ev = MulticlassClassifierEvaluator(self.num_classes)
        return ev.evaluate(np.asarray(merged_preds), np.asarray(merged_labels))

    __call__ = evaluate
