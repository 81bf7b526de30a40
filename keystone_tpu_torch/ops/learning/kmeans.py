"""K-Means++ seeding and Lloyd's iterations (counterpart of
``keystone_tpu/ops/learning/kmeans.py``).

``KMeansModel`` emits the one-hot nearest-center assignment matrix. The
estimator seeds on the host in float64 numpy — sequential by
construction, and its distances feed a probability draw — with the same
``default_rng(seed)`` sequence of ``integers`` and ``choice`` calls as the
JAX package, then runs Lloyd's iterations on the data's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from keystone_tpu_torch.parallel.dataset import Dataset, require_unsharded
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Estimator, Transformer


def _sq_dist_to_centers(X, means):
    """0.5·‖x−μ‖², (n, k): XSqNormHlf − X μᵀ + MSqNormHlf."""
    xsq = 0.5 * torch.sum(X * X, dim=1, keepdim=True)
    msq = 0.5 * torch.sum(means * means, dim=1)
    return xsq - mm(X, means.T) + msq[None, :]


def _one_hot(idx, k, dtype):
    return torch.nn.functional.one_hot(idx, k).to(dtype)


def _assign_one_hot(X, means):
    nearest = torch.argmin(_sq_dist_to_centers(X, means), dim=1)
    return _one_hot(nearest, means.shape[0], X.dtype)


@dataclasses.dataclass(eq=False)
class KMeansModel(Transformer):
    means: Any  # (k, d)

    def apply(self, x):
        return _assign_one_hot(x[None, :], self.means)[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        out = _assign_one_hot(ds.local(), self.means)
        return Dataset(arrays=out * ds.mask()[:, None], n=ds.n, mesh=ds.mesh)


def kmeans_plus_plus_centers(X: np.ndarray, num_means: int,
                             rng: np.random.Generator) -> np.ndarray:
    """Row indices of the k-means++ seeds of float64 ``X`` (n, d)."""
    n = X.shape[0]
    xsq_half = 0.5 * np.sum(X * X, axis=1)
    centers = np.zeros(num_means, dtype=np.int64)
    centers[0] = rng.integers(0, n)
    cur_sq_dist = None
    for k in range(num_means - 1):
        c = X[centers[k]]
        d_new = xsq_half - X @ c + 0.5 * (c @ c)
        cur_sq_dist = d_new if cur_sq_dist is None else np.minimum(d_new, cur_sq_dist)
        p = np.maximum(cur_sq_dist, 0.0)
        total = p.sum()
        if total <= 0:
            centers[k + 1] = rng.integers(0, n)
        else:
            centers[k + 1] = rng.choice(n, p=p / total)
    return centers


@dataclasses.dataclass(eq=False)
class KMeansPlusPlusEstimator(Estimator):
    """One round = k-means++ seeding and one Lloyd's step; more rounds
    run Lloyd's until the cost improves by less than ``stop_tolerance``."""

    num_means: int
    max_iterations: int
    stop_tolerance: float = 1e-3
    seed: int = 0

    def fit(self, data) -> KMeansModel:
        require_unsharded(data, "KMeansPlusPlusEstimator")
        X = data.array() if isinstance(data, Dataset) else torch.as_tensor(data)
        return self.fit_matrix(X.to(torch.float32))

    def fit_matrix(self, X: torch.Tensor) -> KMeansModel:
        """Seeds from ``X`` copied to the host in float64; Lloyd's on
        ``X``'s device in float32."""
        rng = np.random.default_rng(self.seed)
        centers = kmeans_plus_plus_centers(
            X.detach().cpu().numpy().astype(np.float64), self.num_means, rng
        )
        means = X[torch.as_tensor(centers, device=X.device)]
        prev_cost = None
        for _ in range(self.max_iterations):
            d = _sq_dist_to_centers(X, means)
            cost = float(torch.mean(torch.amin(d, dim=1)))
            assign = _one_hot(torch.argmin(d, dim=1), self.num_means, torch.float32)
            mass = torch.sum(assign, dim=0)
            means = mm(assign.T, X) / torch.clamp(mass, min=1.0)[:, None]
            if prev_cost is not None and (
                prev_cost - cost
            ) < self.stop_tolerance * abs(prev_cost):
                break
            prev_cost = cost
        return KMeansModel(means)
