"""Binary evaluation — one-pass contingency table.

Reference: evaluation/BinaryClassifierEvaluator.scala:17,59
(counterpart of ``keystone_tpu/evaluation/binary.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from keystone_tpu_torch.evaluation.multiclass import BinaryMetricsView, host_array


@dataclasses.dataclass
class BinaryClassificationMetrics(BinaryMetricsView):
    @property
    def specificity(self) -> float:
        d = self.tn + self.fp
        return float(self.tn / d) if d else 1.0

    def summary(self) -> str:
        return (
            f"Accuracy: {self.accuracy:.4f}  Precision: {self.precision:.4f}"
            f"  Recall: {self.recall:.4f}  F1: {self.f1:.4f}"
        )


class BinaryClassifierEvaluator:
    """evaluate(predictions: bool, labels: bool) -> metrics."""

    def evaluate(self, predictions: Any, labels: Any) -> BinaryClassificationMetrics:
        pred = _to_bool(predictions)
        lab = _to_bool(labels)
        if pred.shape[0] != lab.shape[0]:
            raise ValueError("length mismatch")
        tp = float(np.sum(pred & lab))
        fp = float(np.sum(pred & ~lab))
        fn = float(np.sum(~pred & lab))
        tn = float(np.sum(~pred & ~lab))
        return BinaryClassificationMetrics(tp, fp, tn, fn)

    __call__ = evaluate


def _to_bool(x: Any) -> np.ndarray:
    return host_array(x).reshape(-1).astype(bool)
