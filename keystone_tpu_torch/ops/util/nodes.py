"""Representation/utility nodes on the flagship path (counterpart of
``keystone_tpu/ops/util/nodes.py``: ``TopKClassifier``,
``VectorCombiner``, ``MatrixVectorizer`` and ``FloatToDouble``)."""

from __future__ import annotations

import dataclasses

import torch

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer


@dataclasses.dataclass(eq=False)
class TopKClassifier(Transformer):
    """top-k class indices, best first."""

    k: int

    def apply(self, scores):
        return torch.topk(scores, min(self.k, scores.shape[-1]), dim=-1).indices

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)


class VectorCombiner(Transformer):
    """Concatenate gathered branch outputs along the feature axis."""

    def apply(self, parts):
        return torch.cat([p.reshape(-1) for p in parts], dim=0)

    def apply_batch(self, ds: Dataset) -> Dataset:
        arrs = ds.padded()
        if isinstance(arrs, tuple):
            flat = [a.reshape(a.shape[0], -1) for a in arrs]
            return Dataset.from_array(torch.cat(flat, dim=1), n=ds.n)
        return ds.map(self.apply)

    def eq_key(self):
        return ("vector_combiner",)


class MatrixVectorizer(Transformer):
    """Flatten a matrix datum into a vector, column-major (Breeze's
    DenseMatrix.toDenseVector order)."""

    def apply(self, m):
        return m.transpose(-1, -2).reshape(-1)

    def apply_batch(self, ds: Dataset) -> Dataset:
        x = ds.padded()
        return Dataset.from_array(
            x.transpose(-1, -2).reshape(x.shape[0], -1), n=ds.n
        )

    def eq_key(self):
        return ("matrix_vectorizer",)


class FloatToDouble(Transformer):
    """Keeps float32, as the JAX package does with x64 off (its default):
    the float64 branch there never runs on the serving path."""

    def apply(self, x):
        return x.to(torch.float32)

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("float_to_double",)
