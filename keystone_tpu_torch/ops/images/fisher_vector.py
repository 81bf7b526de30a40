"""Fisher vector encoding from GMM posteriors, batched over images
(counterpart of ``keystone_tpu/ops/images/fisher_vector.py``).

Input per example: a (d, m) descriptor matrix; output: the (d, 2k) FV.
``FisherVector`` computes the statistics with plain products (the k < 32
choice); ``FisherVectorFused`` with the ``fisher_vector_stats`` kernel
(the k >= 32 choice), which never writes the (m, k) posterior to device
memory. Both run over chunks of images (``utils/chunks.py``).

``GMMFisherVectorEstimator`` fits the GMM on the descriptor columns
(host-stepped EM) and picks the node the same way: the fused kernel at
k >= 32 (``EncEvalGMMFisherVectorEstimator``), plain products below
(``ScalaGMMFisherVectorEstimator``).
"""

from __future__ import annotations

import dataclasses

import torch

from keystone_tpu_torch.ops.images.fv_kernel import fisher_vector_stats
from keystone_tpu_torch.ops.learning.gmm import (
    GaussianMixtureModel,
    GaussianMixtureModelEstimator,
)
from keystone_tpu_torch.ops.learning.pca import matrix_columns
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils.chunks import map_rows
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Estimator, Transformer
from keystone_tpu_torch.workflow.node_optimization import Optimizable


def _fv_from_stats(gmm, s0, s1, s2):
    """Sanchez FV from the (already /m) statistics, batched: s0 (B, k),
    s1/s2 (B, d, k) -> (B, d, 2k)."""
    means, variances = gmm.means, gmm.variances  # (d, k)
    weights = gmm.weights  # (k,)
    s0 = s0[:, None, :]
    fv1 = (s1 - means * s0) / (torch.sqrt(variances) * torch.sqrt(weights))
    fv2 = (s2 - 2.0 * means * s1 + (means * means - variances) * s0) / (
        variances * torch.sqrt(2.0 * weights)
    )
    return torch.cat([fv1, fv2], dim=-1)


@dataclasses.dataclass(eq=False)
class FisherVector(Transformer):
    gmm: GaussianMixtureModel

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, d, m) descriptors -> (B, d, 2k)."""
        m = x.shape[2]
        q = self.gmm._posteriors(x.transpose(1, 2))  # (B, m, k)
        s0 = torch.mean(q, dim=1)
        s1 = mm(x, q) / m
        s2 = mm(x * x, q) / m
        return _fv_from_stats(self.gmm, s0, s1, s2)

    def apply(self, x):
        return self.encode(x.to(torch.float32)[None])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:  # descriptor matrices of several widths
            return self._bucketed_batch(ds)
        return Dataset.from_array(
            map_rows(lambda x: self.encode(x.to(torch.float32)), ds.padded()), n=ds.n
        )


@dataclasses.dataclass(eq=False)
class FisherVectorFused(Transformer):
    """FV through the fused statistics kernel (``fv_kernel``)."""

    gmm: GaussianMixtureModel

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        g = self.gmm
        s0, s1, s2 = fisher_vector_stats(
            x.contiguous(), g.means, g.variances, g.weights, g.weight_threshold
        )
        return _fv_from_stats(g, s0, s1, s2)

    def apply(self, x):
        return self.encode(x.to(torch.float32)[None])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:  # descriptor matrices of several widths
            return self._bucketed_batch(ds)
        return Dataset.from_array(
            map_rows(lambda x: self.encode(x.to(torch.float32)), ds.padded()), n=ds.n
        )


# (d, m) descriptor matrices -> one (N, d) array of their columns, as the
# PCA fit takes them
_columns_of = matrix_columns


@dataclasses.dataclass(eq=False)
class ScalaGMMFisherVectorEstimator(Estimator):
    """GMM fit, then the FV by plain products."""

    k: int
    seed: int = 0

    def fit(self, data: Dataset) -> FisherVector:
        gmm = GaussianMixtureModelEstimator(self.k, seed=self.seed).fit(_columns_of(data))
        return FisherVector(gmm)


@dataclasses.dataclass(eq=False)
class EncEvalGMMFisherVectorEstimator(Estimator):
    """GMM fit, then the FV through the fused statistics kernel."""

    k: int
    seed: int = 0

    def fit(self, data: Dataset) -> FisherVectorFused:
        gmm = GaussianMixtureModelEstimator(self.k, seed=self.seed).fit(_columns_of(data))
        return FisherVectorFused(gmm)


# the vocabulary from which the Fisher vector runs the fused kernel
FUSED_MIN_K = 32


def fisher_vector_of(gmm: GaussianMixtureModel) -> Transformer:
    """The Fisher-vector node ``GMMFisherVectorEstimator`` fits around
    ``gmm``: fused at k >= ``FUSED_MIN_K``, plain products below."""
    return FisherVectorFused(gmm) if gmm.k >= FUSED_MIN_K else FisherVector(gmm)


@dataclasses.dataclass(eq=False)
class GMMFisherVectorEstimator(Estimator, Optimizable):
    """The fused kernel at k >= ``FUSED_MIN_K`` (posteriors never leave
    the chip), plain products below."""

    k: int
    seed: int = 0

    def _choice(self) -> Estimator:
        if self.k >= FUSED_MIN_K:
            return EncEvalGMMFisherVectorEstimator(self.k, self.seed)
        return ScalaGMMFisherVectorEstimator(self.k, self.seed)

    def fit(self, data: Dataset) -> Transformer:
        return self._choice().fit(data)

    def optimize(self, samples, n_total: int):
        return self._choice()
