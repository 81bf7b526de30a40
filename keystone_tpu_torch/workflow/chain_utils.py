"""Transformer/estimator fusion chains.

Reference: workflow/ChainUtils.scala:12,22,35 — TransformerChain,
TransformerEstimatorChain, TransformerLabelEstimatorChain: fuse a
transformer in front of an estimator so the pair presents as ONE estimator
(used by LeastSquaresEstimator's physical options, e.g. Densify() +
BlockLeastSquaresEstimator). Counterpart of
``keystone_tpu/workflow/chain_utils.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import (
    Estimator,
    LabelEstimator,
    Transformer,
)


@dataclasses.dataclass(eq=False)
class TransformerChain(Transformer):
    """Apply a sequence of transformers as one (reference:
    ChainUtils.scala:12)."""

    transformers: Sequence[Transformer]

    def apply(self, x):
        for t in self.transformers:
            x = t.apply(x)
        return x

    def apply_batch(self, ds: Dataset) -> Dataset:
        for t in self.transformers:
            ds = t.apply_batch(ds)
        return ds


@dataclasses.dataclass(eq=False)
class TransformerEstimatorChain(Estimator):
    """transformer + estimator fused into one estimator; the fit result is
    transformer andThen fitted (reference: ChainUtils.scala:22)."""

    transformer: Transformer
    estimator: Estimator

    def fit(self, data: Dataset) -> Transformer:
        fitted = self.estimator.fit(self.transformer.apply_batch(data))
        return TransformerChain([self.transformer, fitted])

    @property
    def weight(self) -> int:
        return getattr(self.estimator, "weight", 1)


@dataclasses.dataclass(eq=False)
class TransformerLabelEstimatorChain(LabelEstimator):
    """Same with a LabelEstimator (reference: ChainUtils.scala:35)."""

    transformer: Transformer
    estimator: LabelEstimator

    def fit(self, data: Dataset, labels: Dataset) -> Transformer:
        fitted = self.estimator.fit(
            self.transformer.apply_batch(data), labels
        )
        return TransformerChain([self.transformer, fitted])

    @property
    def weight(self) -> int:
        return getattr(self.estimator, "weight", 1)
