"""Diagonal-covariance Gaussian mixture model, posterior path (counterpart
of ``keystone_tpu/ops/learning/gmm.py``: ``GaussianMixtureModel`` and
``_log_likelihoods_dk``; EM waits for the training slice)."""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer


def _log_likelihoods_dk(X, mu_dk, var_dk, weights):
    """(..., n, k) log p(x, cluster) for (..., n, d) rows ``X``:
    −½‖x−μ‖²_Λ − ½Σlog var + log w + const, with (d, k) ``mu_dk`` /
    ``var_dk``. Float32 products (TF32 off on the card)."""
    d = X.shape[-1]
    xsq = X * X
    sq_mahl = (
        torch.matmul(xsq, 0.5 / var_dk)
        - torch.matmul(X, mu_dk / var_dk)
        + 0.5 * torch.sum(mu_dk * mu_dk / var_dk, dim=0)
    )
    return (
        -0.5 * d * math.log(2 * math.pi)
        - 0.5 * torch.sum(torch.log(var_dk), dim=0)
        + torch.log(weights)
        - sq_mahl
    )


@dataclasses.dataclass(eq=False)
class GaussianMixtureModel(Transformer):
    """Thresholded posterior assignments. ``means``/``variances`` are
    (dims, k) — each column one cluster."""

    means: Any  # (d, k)
    variances: Any  # (d, k)
    weights: Any  # (k,)
    weight_threshold: float = 1e-4

    def _posteriors(self, X):
        llh = _log_likelihoods_dk(X, self.means, self.variances, self.weights)
        # shifted softmax (peak at 0) + aggressive thresholding
        llh = llh - torch.amax(llh, dim=-1, keepdim=True)
        q = torch.exp(llh)
        q = q / torch.sum(q, dim=-1, keepdim=True)
        q = torch.where(q > self.weight_threshold, q, torch.zeros((), device=q.device))
        return q / torch.sum(q, dim=-1, keepdim=True)

    def apply(self, x):
        return self._posteriors(x[None, :])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        q = self._posteriors(ds.padded())
        return Dataset.from_array(q * ds.mask()[:, None], n=ds.n)
