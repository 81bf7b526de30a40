"""Representation/utility nodes (counterpart of
``keystone_tpu/ops/util/nodes.py``): ``VectorSplitter``,
``ClassLabelIndicators``, ``ClassLabelIndicatorsFromIntArrayLabels``,
``MaxClassifier``, ``TopKClassifier``, ``VectorCombiner``,
``MatrixVectorizer`` and ``FloatToDouble``; the text apps' ``Densify``,
``Sparsify``, ``Shuffler`` and the sparse feature space:
``SparseFeatureVectorizer`` and its estimators ``CommonSparseFeatures``
and ``AllSparseFeatures``. Sparse rows are the ``Dataset``'s CSR mode.
The feature-space estimators count on the host in the JAX package's
order, so both packages give every feature the same column."""

from __future__ import annotations

import dataclasses
import logging
from collections import Counter
from itertools import chain, repeat
from typing import Any, List

import numpy as np
import torch

from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.dataset import Dataset, csr_from_coo, is_sparse
from keystone_tpu_torch.parallel.shuffle import device_shuffle
from keystone_tpu_torch.workflow.api import Estimator, FunctionNode, Transformer


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
        out = _indicators(ds.local().to(torch.int64), self.num_classes)
        # the indicator of a zero pad row is (+1, -1, ...): keep pad rows zero
        return Dataset.from_array(out * ds.mask()[:, None], n=ds.n, mesh=ds.mesh)


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


class Densify(Transformer):
    """Sparse rows -> dense."""

    def apply(self, x):
        return x.to_dense() if x.layout != torch.strided else x

    def apply_batch(self, ds: Dataset) -> Dataset:
        if ds.is_array:
            x = ds.local()
            return Dataset.from_array(x.to_dense(), n=ds.n) if is_sparse(x) else ds
        return ds.map(self.apply)

    def eq_key(self):
        return ("densify",)


class Sparsify(Transformer):
    """Dense -> sparse rows (the stored entries are the nonzeros, as
    ``BCOO.fromdense`` keeps them)."""

    def apply(self, x):
        return torch.as_tensor(x).to_sparse()

    def apply_batch(self, ds: Dataset) -> Dataset:
        x = ds.to_array_mode().padded()
        return Dataset.from_array(x.to_sparse_csr(), n=ds.n)

    def eq_key(self):
        return ("sparsify",)


class Shuffler(Transformer):
    """Random permutation of examples (reference: repartition-based
    Shuffler), ``out[j] = x[perm[j]]`` with ``perm =
    default_rng(seed).permutation(n)`` as in the JAX package.
    ``device=True`` routes the rows through one exchange over the mesh's
    shards (``parallel/shuffle.device_shuffle``, the pad rows zero, as the
    JAX package's ``lax.all_to_all`` path leaves them): sharded rows where
    they are, an unsharded array sharded over the current mesh first; rows
    that do not divide over its shards take the logged host path, as in
    the JAX package. The host path permutes on the host and returns the
    ``n`` valid rows on the array's device. Both give the same rows."""

    def __init__(self, seed: int = 0, device: bool = False):
        self.seed = seed
        self.device = device

    def apply(self, x):
        return x

    def apply_batch(self, ds: Dataset) -> Dataset:
        if self.device and ds.is_array and not isinstance(ds.local(), tuple):
            if ds.is_sharded:
                return Dataset.from_array(device_shuffle(ds.local(), ds.n, self.seed, ds.mesh),
                                          n=ds.n, mesh=ds.mesh)
            mesh = mesh_lib.current_mesh()
            shards = mesh_lib.n_data_shards(mesh)
            x = ds.padded()
            if shards == 1:
                return Dataset.from_array(device_shuffle(x, ds.n, self.seed, mesh), n=ds.n)
            if x.shape[0] % shards == 0:
                sh = ds.shard(mesh)
                return Dataset.from_array(device_shuffle(sh.local(), ds.n, self.seed, mesh),
                                          n=ds.n, mesh=mesh)
            logging.getLogger(__name__).warning(
                "Shuffler(device=True): %d padded rows not divisible by %d data shards; "
                "falling back to the host path (full array materializes on host)",
                x.shape[0], shards,
            )
        perm = np.random.default_rng(self.seed).permutation(ds.n)
        if ds.is_array and not isinstance(ds.padded(), tuple):
            x = ds.array()
            return Dataset.from_array(x.cpu()[torch.as_tensor(perm)].to(x.device), n=ds.n)
        items = ds.items()
        return Dataset.from_items([items[i] for i in perm])


# -- sparse feature space estimators ---------------------------------------


@dataclasses.dataclass(eq=False)
class SparseFeatureVectorizer(Transformer):
    """term-count dict -> sparse vector given a feature -> column map
    (reference: nodes/util/SparseFeatureVectorizer.scala). A batch becomes
    one (n, dim) CSR matrix on the host; the consumer moves it to its
    device."""

    feature_index: dict
    dim: int

    def apply(self, counts: dict):
        pairs = sorted((j, v) for j, v in
                       ((self.feature_index.get(k), v) for k, v in counts.items())
                       if j is not None)
        return torch.sparse_coo_tensor(
            torch.tensor([[j for j, _ in pairs]], dtype=torch.int64).reshape(1, -1),
            torch.tensor([float(v) for _, v in pairs], dtype=torch.float32),
            (self.dim,), is_coalesced=True,
        )

    def apply_batch(self, ds: Dataset) -> Dataset:
        # every (term, value) of every document looked up in C loops
        # (map, chain, fromiter); a term outside the index gets column -1
        items = ds.items()
        lens = np.fromiter(map(len, items), np.int64, len(items))
        total = int(lens.sum())
        cols = np.fromiter(map(self.feature_index.get, chain.from_iterable(items), repeat(-1)),
                           np.int64, total)
        vals = np.fromiter(chain.from_iterable(c.values() for c in items), np.float32, total)
        rows = np.repeat(np.arange(len(items)), lens)
        keep = cols >= 0
        mat = csr_from_coo(rows[keep], cols[keep], vals[keep], (len(items), self.dim))
        return Dataset.from_array(mat, n=len(items))

    def eq_key(self):
        return ("sparse_vectorizer", self.dim, id(self.feature_index))


@dataclasses.dataclass(eq=False)
class CommonSparseFeatures(Estimator):
    """Keep the ``num_features`` most frequent features (reference:
    nodes/util/CommonSparseFeatures.scala); ties in first-seen order, as
    ``Counter.most_common`` orders them."""

    num_features: int

    def fit(self, data: Dataset) -> SparseFeatureVectorizer:
        counts: Counter = Counter()
        for item in data.items():
            # every occurrence counts once, whatever its value
            # (CommonSparseFeatures.scala:37)
            counts.update(item.keys())
        top = [k for k, _ in counts.most_common(self.num_features)]
        index = {k: i for i, k in enumerate(top)}
        return SparseFeatureVectorizer(index, self.num_features)


@dataclasses.dataclass(eq=False)
class AllSparseFeatures(Estimator):
    """Keep every observed feature, ordered by ``str`` (reference:
    nodes/util/AllSparseFeatures.scala)."""

    def fit(self, data: Dataset) -> SparseFeatureVectorizer:
        seen = set()
        for item in data.items():
            seen.update(item.keys())
        ordered = sorted(seen, key=lambda k: str(k))
        index = {k: i for i, k in enumerate(ordered)}
        return SparseFeatureVectorizer(index, len(ordered))
