"""Fisher vector encoding from GMM posteriors, batched over images
(counterpart of ``keystone_tpu/ops/images/fisher_vector.py``).

Input per example: a (d, m) descriptor matrix; output: the (d, 2k) FV.
``FisherVector`` computes the statistics with plain products (the k < 32
choice); ``FisherVectorFused`` with the ``fisher_vector_stats`` kernel
(the k >= 32 choice), which never writes the (m, k) posterior to device
memory.
"""

from __future__ import annotations

import dataclasses

import torch

from keystone_tpu_torch.ops.images.fv_kernel import fisher_vector_stats
from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Transformer


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
        return Dataset.from_array(self.encode(ds.padded().to(torch.float32)), n=ds.n)


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
        return Dataset.from_array(self.encode(ds.padded().to(torch.float32)), n=ds.n)
