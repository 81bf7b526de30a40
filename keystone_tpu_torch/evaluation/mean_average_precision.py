"""VOC-style 11-point interpolated mean average precision.

Reference: evaluation/MeanAveragePrecisionEvaluator.scala:11
(counterpart of ``keystone_tpu/evaluation/mean_average_precision.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from keystone_tpu_torch.evaluation.multiclass import host_array
from keystone_tpu_torch.parallel.dataset import Dataset


class MeanAveragePrecisionEvaluator:
    """evaluate(actuals: list of per-example positive-class index arrays,
    scores: (n, classes) score matrix) -> (classes,) per-class AP."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, actuals: Any, scores: Any) -> np.ndarray:
        if hasattr(actuals, "get"):
            actuals = actuals.get()
        if hasattr(scores, "get"):
            scores = scores.get()
        if isinstance(actuals, Dataset):
            actuals = actuals.items()
        if isinstance(scores, Dataset):
            scores = scores.array()
        scores = host_array(scores)
        aps = np.zeros(self.num_classes)
        for c in range(self.num_classes):
            labels = np.array(
                [c in np.atleast_1d(host_array(a)) for a in actuals]
            )
            aps[c] = self._average_precision(scores[:, c], labels)
        return aps

    __call__ = evaluate

    @staticmethod
    def _average_precision(scores: np.ndarray, labels: np.ndarray) -> float:
        """11-point interpolated AP (VOC2007 convention, matching the
        reference's implementation)."""
        order = np.argsort(-scores, kind="stable")
        sorted_labels = labels[order]
        tp = np.cumsum(sorted_labels)
        n_pos = labels.sum()
        if n_pos == 0:
            return 0.0
        recall = tp / n_pos
        precision = tp / np.arange(1, len(scores) + 1)
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            mask = recall >= t
            p = precision[mask].max() if mask.any() else 0.0
            ap += p / 11.0
        return float(ap)
