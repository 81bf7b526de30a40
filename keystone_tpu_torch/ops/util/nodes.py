"""Representation/utility nodes (counterpart of
``keystone_tpu/ops/util/nodes.py``): ``VectorSplitter``,
``ClassLabelIndicators``, ``ClassLabelIndicatorsFromIntArrayLabels``,
``MaxClassifier``, ``TopKClassifier``, ``VectorCombiner``,
``MatrixVectorizer`` and ``FloatToDouble``."""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import FunctionNode, Transformer


class VectorSplitter(FunctionNode):
    """Split a dataset of feature vectors into feature-dimension blocks —
    the primitive behind all block solvers (reference:
    nodes/util/VectorSplitter.scala). Returns a list of Datasets, one per
    block (column views of the rows); the last block may be narrower."""

    def __init__(self, block_size: int, num_features: int = None):
        self.block_size = block_size
        self.num_features = num_features

    def apply(self, data: Any) -> List[Dataset]:
        ds = Dataset.of(data)
        x = ds.padded()
        d = self.num_features or x.shape[1]
        return [
            Dataset.from_array(x[:, s : min(s + self.block_size, d)], n=ds.n)
            for s in range(0, d, self.block_size)
        ]


def _indicators(y: torch.Tensor, num_classes: int) -> torch.Tensor:
    """±1 one-hot rows; a label outside [0, num_classes) gives a row of
    −1, as ``jax.nn.one_hot`` gives zeros for it."""
    classes = torch.arange(num_classes, device=y.device)
    return 2.0 * (y[..., None] == classes).to(torch.float32) - 1.0


@dataclasses.dataclass(eq=False)
class ClassLabelIndicators(Transformer):
    """int label -> ±1 indicator vector."""

    num_classes: int

    def apply(self, y):
        return _indicators(torch.as_tensor(y), self.num_classes)

    def apply_batch(self, ds: Dataset) -> Dataset:
        out = _indicators(ds.padded().to(torch.int64), self.num_classes)
        # the indicator of a zero pad row is (+1, -1, ...): keep pad rows zero
        return Dataset.from_array(out * ds.mask()[:, None], n=ds.n)


@dataclasses.dataclass(eq=False)
class ClassLabelIndicatorsFromIntArrayLabels(Transformer):
    """multi-label int array -> ±1 indicator vector (float32, on the host,
    as the labels come from the loader; the solver moves them to its
    device)."""

    num_classes: int

    def apply(self, ys):
        base = -np.ones(self.num_classes, dtype=np.float32)
        base[np.asarray(ys, dtype=np.int64)] = 1.0
        return torch.from_numpy(base)

    def apply_batch(self, ds: Dataset) -> Dataset:
        # the label arrays differ in length: mapped one by one on the host
        return Dataset.from_items([self.apply(ys) for ys in ds.items()])


class MaxClassifier(Transformer):
    """argmax over scores, the first of tied maxima (reference:
    nodes/util/MaxClassifier.scala)."""

    def apply(self, scores):
        return torch.argmax(scores, dim=-1)

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("max_classifier",)


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest scores along the last axis, best
    first, ties to the lower index, as ``jax.lax.top_k`` orders them: the
    first ``k`` of a stable descending sort (``torch.topk`` gives ties in
    no set order). A sort is one kernel with no host sync, so a CUDA graph
    captures it."""
    k = min(k, scores.shape[-1])
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


@dataclasses.dataclass(eq=False)
class TopKClassifier(Transformer):
    """top-k class indices, best first, ties to the lower index."""

    k: int

    def apply(self, scores):
        return top_k_indices(scores, self.k)

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
