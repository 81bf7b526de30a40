"""Diagonal-covariance Gaussian mixture model: posteriors and EM
(counterpart of ``keystone_tpu/ops/learning/gmm.py``).

One EM loop, stepped from the host: it reads the cost back each step and
stops BEFORE applying an update when converged or unbalanced.
``FusedGMMEstimator`` keeps the name of the JAX package's single
``lax.while_loop`` program; in PyTorch that program is the same Python
loop over the same device work, so it runs this one.
``OptimizableGMMEstimator`` picks it at k >= 32, as the JAX package
does. The E and M steps run on the data's device in float32 (TF32 off on
the card); the k-means++ seeding of the initialisation runs on the host
(``kmeans.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from keystone_tpu_torch.ops.learning.kmeans import KMeansPlusPlusEstimator
from keystone_tpu_torch.parallel.dataset import Dataset, require_unsharded
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Estimator, Transformer
from keystone_tpu_torch.workflow.node_optimization import Optimizable

KMEANS_PLUS_PLUS_INITIALIZATION = "kmeans++"
RANDOM_INITIALIZATION = "random"


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


def _thresholded_posteriors(llh, weight_threshold):
    """Shifted softmax (peak at 0), then aggressive thresholding."""
    q = torch.exp(llh - torch.amax(llh, dim=-1, keepdim=True))
    q = q / torch.sum(q, dim=-1, keepdim=True)
    q = torch.where(q > weight_threshold, q, torch.zeros((), dtype=q.dtype, device=q.device))
    return q / torch.sum(q, dim=-1, keepdim=True)


def _as_matrix(data) -> torch.Tensor:
    require_unsharded(data, "GaussianMixtureModelEstimator")
    X = data.array() if isinstance(data, Dataset) else torch.as_tensor(data)
    return X.to(torch.float32)


@dataclasses.dataclass(eq=False)
class GaussianMixtureModel(Transformer):
    """Thresholded posterior assignments. ``means``/``variances`` are
    (dims, k) — each column one cluster."""

    means: Any  # (d, k)
    variances: Any  # (d, k)
    weights: Any  # (k,)
    weight_threshold: float = 1e-4

    @property
    def k(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[0]

    def _posteriors(self, X):
        llh = _log_likelihoods_dk(X, self.means, self.variances, self.weights)
        return _thresholded_posteriors(llh, self.weight_threshold)

    def apply(self, x):
        return self._posteriors(x[None, :])[0]

    def apply_batch(self, ds: Dataset) -> Dataset:
        q = self._posteriors(ds.local())
        return Dataset(arrays=q * ds.mask()[:, None], n=ds.n, mesh=ds.mesh)

    @staticmethod
    def load(mean_file: str, vars_file: str, weights_file: str,
             delimiter: str = ",", device=None) -> "GaussianMixtureModel":
        """CSV load: (d, k) means and variances, k weights, on ``device``
        (``None`` means ``cuda``)."""
        from keystone_tpu_torch._device import resolve_device

        dev = resolve_device(device)
        means = np.loadtxt(mean_file, delimiter=delimiter, ndmin=2)
        variances = np.loadtxt(vars_file, delimiter=delimiter, ndmin=2)
        weights = np.loadtxt(weights_file, delimiter=delimiter).reshape(-1)
        return GaussianMixtureModel(*(
            torch.as_tensor(np.asarray(a, np.float32), device=dev)
            for a in (means, variances, weights)
        ))


@dataclasses.dataclass(eq=False)
class GaussianMixtureModelEstimator(Estimator):
    """EM over the whole sample, stepped from the host."""

    k: int
    max_iterations: int = 100
    min_cluster_size: int = 40
    stop_tolerance: float = 1e-4
    weight_threshold: float = 1e-4
    small_variance_threshold: float = 1e-2
    absolute_variance_threshold: float = 1e-9
    initialization_method: str = KMEANS_PLUS_PLUS_INITIALIZATION
    seed: int = 0

    def _initialize(self, X, xsq):
        """k-means++ (or random) seeds and the variance floor. Returns (k, d) means and variances, (k,) weights
        and the (d,) floor."""
        n, d = X.shape
        mean_global = torch.mean(X, dim=0)
        var_global = torch.mean(xsq, dim=0) - mean_global * mean_global

        if self.initialization_method == KMEANS_PLUS_PLUS_INITIALIZATION:
            km = KMeansPlusPlusEstimator(self.k, 1, seed=self.seed)
            assign = km.fit(X).apply_batch(Dataset.from_array(X)).padded()
            mass = torch.sum(assign, dim=0)
            inv = 1.0 / torch.clamp(mass, min=1.0)
            weights = mass / n
            mu = inv[:, None] * mm(assign.T, X)
            var = inv[:, None] * mm(assign.T, xsq) - mu * mu
        else:  # RANDOM_INITIALIZATION
            rng = np.random.default_rng(self.seed)
            col_min = torch.amin(X, dim=0)
            col_range = torch.amax(X, dim=0) - col_min
            u = torch.as_tensor(
                rng.uniform(size=(self.k, d)).astype(np.float32), device=X.device
            )
            mu = u * col_range[None, :] + col_min[None, :]
            var = 0.1 * torch.ones((self.k, d), device=X.device) * (col_range * col_range)[None, :]
            weights = torch.full((self.k,), 1.0 / self.k, device=X.device)

        var_lb = torch.clamp(
            self.small_variance_threshold * var_global,
            min=self.absolute_variance_threshold,
        )
        var = torch.maximum(var, var_lb[None, :])
        return mu, var, weights, var_lb

    def _model(self, mu, var, weights) -> GaussianMixtureModel:
        return GaussianMixtureModel(
            mu.T.contiguous(), var.T.contiguous(), weights, self.weight_threshold
        )

    def fit(self, data) -> GaussianMixtureModel:
        X = _as_matrix(data)
        n = X.shape[0]
        xsq = X * X
        mu, var, weights, var_lb = self._initialize(X, xsq)

        prev_cost = None
        for _ in range(self.max_iterations):
            llh = _log_likelihoods_dk(X, mu.T, var.T, weights)
            cost = float(torch.mean(torch.logsumexp(llh, dim=1)))
            if prev_cost is not None and (
                cost - prev_cost
            ) < self.stop_tolerance * abs(prev_cost):
                break
            prev_cost = cost
            q = _thresholded_posteriors(llh, self.weight_threshold)
            # M-step with the min-cluster guard
            q_sum = torch.sum(q, dim=0)
            if bool(torch.any(q_sum < self.min_cluster_size)):
                break  # "Unbalanced clustering, try less centers"
            weights = q_sum / n
            inv = 1.0 / q_sum
            mu = inv[:, None] * mm(q.T, X)
            var = inv[:, None] * mm(q.T, xsq) - mu * mu
            var = torch.maximum(var, var_lb[None, :])
        return self._model(mu, var, weights)


@dataclasses.dataclass(eq=False)
class FusedGMMEstimator(GaussianMixtureModelEstimator):
    """The JAX package's fused EM: the same loop, init, parameters and
    stopping semantics as ``GaussianMixtureModelEstimator``."""


@dataclasses.dataclass(eq=False)
class OptimizableGMMEstimator(GaussianMixtureModelEstimator, Optimizable):
    """The fused EM at k >= 32, the host-stepped EM below."""

    native_k_threshold: int = 32

    def _chosen(self) -> GaussianMixtureModelEstimator:
        cls = (
            FusedGMMEstimator
            if self.k >= self.native_k_threshold
            else GaussianMixtureModelEstimator
        )
        fields = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(GaussianMixtureModelEstimator)
        }
        return cls(**fields)

    @property
    def default(self) -> Estimator:
        return self._chosen()

    def optimize(self, samples, n_total: int) -> Estimator:
        return self._chosen()

    def fit(self, data) -> GaussianMixtureModel:
        return self._chosen().fit(data)
