"""Multiclass evaluation — one-pass confusion matrix + derived metrics.

Reference: evaluation/MulticlassClassifierEvaluator.scala:22,123 (RDD
``aggregate`` of a confusion matrix; micro/macro precision/recall/F1;
Mahout-style pretty-print). Here the confusion matrix is one scatter-add
over the prediction/label tensors, on their device (counterpart of
``keystone_tpu/evaluation/multiclass.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from keystone_tpu_torch.parallel.dataset import Dataset


@dataclasses.dataclass
class MulticlassMetrics:
    confusion_matrix: np.ndarray  # (classes, classes); [actual, predicted]

    @property
    def num_classes(self) -> int:
        return self.confusion_matrix.shape[0]

    @property
    def total(self) -> float:
        return float(self.confusion_matrix.sum())

    def class_metrics(self, c: int) -> "BinaryMetricsView":
        cm = self.confusion_matrix
        tp = cm[c, c]
        fp = cm[:, c].sum() - tp
        fn = cm[c, :].sum() - tp
        tn = self.total - tp - fp - fn
        return BinaryMetricsView(tp, fp, tn, fn)

    @property
    def total_accuracy(self) -> float:
        return float(np.trace(self.confusion_matrix) / max(self.total, 1.0))

    @property
    def total_error(self) -> float:
        return 1.0 - self.total_accuracy

    # micro-averaged metrics equal total accuracy in single-label multiclass
    @property
    def micro_precision(self) -> float:
        return self.total_accuracy

    @property
    def micro_recall(self) -> float:
        return self.total_accuracy

    @property
    def micro_f1(self) -> float:
        return self.total_accuracy

    def _macro(self, f) -> float:
        return float(
            np.mean([f(self.class_metrics(c)) for c in range(self.num_classes)])
        )

    @property
    def macro_precision(self) -> float:
        return self._macro(lambda m: m.precision)

    @property
    def macro_recall(self) -> float:
        return self._macro(lambda m: m.recall)

    @property
    def macro_f1(self) -> float:
        return self._macro(lambda m: m.f1)

    def summary(self, class_names: Optional[list] = None) -> str:
        """Mahout-style text summary (reference:
        MulticlassClassifierEvaluator.scala pprint)."""
        lines = [
            f"Accuracy: {self.total_accuracy:.4f}",
            f"Error: {self.total_error:.4f}",
            f"Macro Precision/Recall/F1: "
            f"{self.macro_precision:.4f}/{self.macro_recall:.4f}/{self.macro_f1:.4f}",
            "Confusion matrix (rows=actual, cols=predicted):",
        ]
        names = class_names or [str(i) for i in range(self.num_classes)]
        header = "\t" + "\t".join(names)
        lines.append(header)
        for i, row in enumerate(self.confusion_matrix.astype(np.int64)):
            lines.append(names[i] + "\t" + "\t".join(str(v) for v in row))
        return "\n".join(lines)


@dataclasses.dataclass
class BinaryMetricsView:
    tp: float
    fp: float
    tn: float
    fn: float

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return float(self.tp / d) if d else 1.0

    @property
    def recall(self) -> float:
        d = self.tp + self.fn
        return float(self.tp / d) if d else 1.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def accuracy(self) -> float:
        t = self.tp + self.fp + self.tn + self.fn
        return float((self.tp + self.tn) / t) if t else 0.0


class MulticlassClassifierEvaluator:
    """evaluate(predictions, labels) -> MulticlassMetrics. Accepts
    PipelineResults, Datasets, or arrays of int class ids."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes

    def evaluate(self, predictions: Any, labels: Any) -> MulticlassMetrics:
        pred = _to_int_array(predictions)
        lab = _to_int_array(labels)
        if pred.shape[0] != lab.shape[0]:
            raise ValueError(
                f"length mismatch: {pred.shape[0]} vs {lab.shape[0]}"
            )
        c = self.num_classes
        # int64 counts: float32 counts would saturate at 2^24. As in JAX's
        # scatter-add, a negative class id counts from the end and one
        # still outside [0, c) is dropped
        lab = lab.to(pred.device)
        lab = torch.where(lab < 0, lab + c, lab)
        pred = torch.where(pred < 0, pred + c, pred)
        ok = (lab >= 0) & (lab < c) & (pred >= 0) & (pred < c)
        cm = torch.zeros((c, c), dtype=torch.int64, device=pred.device)
        cm.index_put_((lab[ok], pred[ok]), torch.ones_like(lab[ok]), accumulate=True)
        return MulticlassMetrics(cm.cpu().numpy().astype(np.float64))

    __call__ = evaluate


def host_array(x: Any) -> np.ndarray:
    """``x`` (a pipeline result, a Dataset, a tensor on any device or an
    array) as a host numpy array."""
    if hasattr(x, "get"):  # PipelineResult
        x = x.get()
    if isinstance(x, Dataset):
        x = x.array()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_int_array(x: Any) -> torch.Tensor:
    if hasattr(x, "get"):  # PipelineResult
        x = x.get()
    if isinstance(x, Dataset):
        x = x.array()
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).to(torch.int64)
    return torch.as_tensor(np.asarray(x).reshape(-1).astype(np.int64))
