"""Evaluators (counterpart of ``keystone_tpu/evaluation``): multiclass,
binary, VOC mean average precision and augmented examples. Predictions
may be tensors on any device, arrays, Datasets or pipeline results."""

from keystone_tpu_torch.evaluation.multiclass import (
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
)
from keystone_tpu_torch.evaluation.binary import (
    BinaryClassifierEvaluator,
    BinaryClassificationMetrics,
)
from keystone_tpu_torch.evaluation.mean_average_precision import (
    MeanAveragePrecisionEvaluator,
)
from keystone_tpu_torch.evaluation.augmented import AugmentedExamplesEvaluator

__all__ = [
    "AugmentedExamplesEvaluator",
    "BinaryClassificationMetrics",
    "BinaryClassifierEvaluator",
    "MeanAveragePrecisionEvaluator",
    "MulticlassClassifierEvaluator",
    "MulticlassMetrics",
]
