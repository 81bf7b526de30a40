"""Probabilistic classifiers: Naive Bayes, logistic regression, LDA
(counterpart of ``keystone_tpu/ops/learning/classifiers.py``).

Reference: nodes/learning/NaiveBayesModel.scala:21,62 (wraps MLlib
NaiveBayes; the model emits log-posteriors π + θx),
LogisticRegressionModel.scala:19,42 (MLlib LBFGS LogisticGradient +
SquaredL2Updater, multinomial), LinearDiscriminantAnalysis.scala:17,39
(local multi-class LDA via eig(S_w⁻¹ S_b)). The sufficient statistics and
gradients are float32 products on the device, sparse rows through CSR
SpMM; LDA's eigenproblem is float64 on the host, as in the JAX package.
The estimators fit on the labels' device and move the data there (the
text apps' sparse rows are made on the host); the models score on their
parameters' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import scipy.linalg
import torch

from keystone_tpu_torch.ops.learning.lbfgs import host_vg, run_lbfgs, run_lbfgs_device
from keystone_tpu_torch.ops.learning.linear import rows_times
from keystone_tpu_torch.parallel.dataset import Dataset, csr_transpose, is_sparse, spmm
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import LabelEstimator, Transformer
from keystone_tpu_torch.workflow.operators import cached_on


@dataclasses.dataclass(eq=False)
class NaiveBayesModel(Transformer):
    """x -> log-posterior scores π + θ·x (reference:
    NaiveBayesModel.scala:21; an argmax downstream picks the class)."""

    pi: Any  # (k,) log class priors
    theta: Any  # (k, d) log feature likelihoods

    def _theta_t(self) -> torch.Tensor:
        return cached_on(self, "theta_t", lambda: self.theta.T.contiguous(), self.theta.device)

    def apply(self, x):
        return self.pi + rows_times(x, self._theta_t())

    def apply_batch(self, ds: Dataset) -> Dataset:
        scores = self.pi + rows_times(ds.padded(), self._theta_t())
        mask = ds.mask().to(scores.device)
        return Dataset.from_array(scores * mask[:, None], n=ds.n)


def _pad_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    if a.shape[0] == n:
        return a
    return torch.cat([a, a.new_zeros((n - a.shape[0],) + tuple(a.shape[1:]))])


def _onehot(y: torch.Tensor, k: int) -> torch.Tensor:
    """float32 one-hot rows; a label outside [0, k) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (y[:, None] == torch.arange(k, device=y.device)).to(torch.float32)


@dataclasses.dataclass(eq=False)
class NaiveBayesEstimator(LabelEstimator):
    """Multinomial NB with Laplace smoothing (reference:
    NaiveBayesModel.scala:62, MLlib NaiveBayes.train(lambda)). A label
    outside [0, num_classes) poisons the model with NaN (no host sync), as
    in the JAX package; ``pi`` divides by the unpadded n."""

    num_classes: int
    lam: float = 1.0

    def fit(self, data: Dataset, labels: Dataset) -> NaiveBayesModel:
        # float labels train as their integer part, as in the JAX package
        y = labels.to_array_mode().array().reshape(-1).to(torch.int32)
        x = data.to_array_mode().padded().to(y.device)
        onehot = _onehot(y, self.num_classes)
        bad = torch.any((y < 0) | (y >= self.num_classes))
        onehot = torch.where(bad, torch.full_like(onehot, float("nan")), onehot)
        ys = _pad_rows(onehot, x.shape[0])  # pad rows of x are zero
        if is_sparse(x):
            counts = spmm(csr_transpose(x), ys).T
        else:
            counts = mm(ys.T, x)
        class_counts = onehot.sum(dim=0)
        pi = torch.log(class_counts + self.lam) - np.log(
            y.shape[0] + self.num_classes * self.lam
        )
        totals = torch.sum(counts, dim=1, keepdim=True)
        theta = torch.log(counts + self.lam) - torch.log(totals + self.lam * counts.shape[1])
        return NaiveBayesModel(pi, theta.contiguous())


def _logistic_vg(W, x, onehot, mask, n, reg, xt=None):
    """Softmax cross-entropy mean loss + L2 and its gradient, the
    ``vg(W, *data)`` the L-BFGS drivers take. ``xt`` is the CSR of ``xᵀ``
    for sparse ``x``."""
    logits = spmm(x, W) if xt is not None else mm(x, W)
    logz = torch.logsumexp(logits, dim=1)
    ll = torch.sum((logz - torch.sum(logits * onehot, dim=1)) * mask)
    p = torch.exp(logits - logz[:, None]) * mask[:, None]
    g = spmm(xt, p - onehot) if xt is not None else mm(x.T, p - onehot)
    return ll / n + 0.5 * reg * torch.sum(W * W), g / n + reg * W


@dataclasses.dataclass(eq=False)
class LogisticRegressionModel(Transformer):
    """argmax-of-logits classifier (reference:
    LogisticRegressionModel.scala:19, MLlib model.predict)."""

    W: Any  # (d, k)

    def apply(self, x):
        return torch.argmax(rows_times(x, self.W), dim=-1)

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(torch.argmax(rows_times(ds.padded(), self.W), dim=-1), n=ds.n)


@dataclasses.dataclass(eq=False)
class LogisticRegressionEstimator(LabelEstimator):
    """Multinomial logistic regression by full-batch L-BFGS (reference:
    LogisticRegressionModel.scala:42, MLlib LogisticRegressionWithLBFGS +
    SquaredL2Updater): the softmax cross-entropy gradient on the device,
    the device driver (``run_lbfgs_device``) by default or the float64
    host driver. ``fit_stats`` holds the last device fit's iterations,
    value-and-gradient calls and host syncs."""

    num_classes: int
    num_iters: int = 20
    reg_param: float = 0.0
    convergence_tol: float = 1e-4
    driver: str = "device"

    def fit(self, data: Dataset, labels: Dataset) -> LogisticRegressionModel:
        if self.driver not in ("device", "host"):
            raise ValueError(f"driver must be 'device' or 'host', got {self.driver!r}")
        y_dev = labels.to_array_mode().array().reshape(-1)
        y = y_dev.cpu().numpy().astype(np.int64)
        if y.size and (y.min() < 0 or y.max() >= self.num_classes):
            # an eye(k)[y] would wrap negatives (e.g. -1/+1 binary labels)
            # into valid classes and corrupt the fit
            raise ValueError(
                f"labels must be class ids in [0, {self.num_classes}); "
                f"got range [{y.min()}, {y.max()}]"
            )
        dev = y_dev.device
        data = data.to_array_mode()
        x = data.padded().to(dev)
        n = data.n
        d = x.shape[1]
        k = self.num_classes
        onehot = _pad_rows(torch.as_tensor(np.eye(k, dtype=np.float32)[y], device=dev),
                           x.shape[0])
        mask = data.mask().to(dev)
        xt = csr_transpose(x) if is_sparse(x) else None
        vg_data = (x, onehot, mask, float(n), float(self.reg_param), xt)
        if self.driver == "device":
            self.fit_stats = {}
            W = run_lbfgs_device(
                _logistic_vg, torch.zeros((d, k), dtype=torch.float32, device=dev),
                self.num_iters, convergence_tol=self.convergence_tol, data=vg_data,
                stats=self.fit_stats,
            )
            return LogisticRegressionModel(W)
        w = run_lbfgs(host_vg(_logistic_vg, (d, k), dev, *vg_data), np.zeros((d, k)),
                      self.num_iters, convergence_tol=self.convergence_tol)
        return LogisticRegressionModel(
            torch.as_tensor(w.reshape(d, k), dtype=torch.float32, device=dev))


@dataclasses.dataclass(eq=False)
class LinearDiscriminantAnalysis(LabelEstimator):
    """Multi-class LDA: project onto the top eigenvectors of S_w⁻¹ S_b
    (reference: LinearDiscriminantAnalysis.scala:17,39, a local eig),
    float64 on the host; the projection on the data's device."""

    num_dimensions: int

    def fit(self, data: Dataset, labels: Dataset):
        from keystone_tpu_torch.ops.learning.linear import LinearMapper

        arr = data.to_array_mode().array()
        X = arr.detach().cpu().numpy().astype(np.float64)
        y = labels.to_array_mode().array().cpu().numpy().reshape(-1).astype(np.int64)
        classes = np.unique(y)
        d = X.shape[1]
        overall_mean = X.mean(axis=0)
        Sw = np.zeros((d, d))
        Sb = np.zeros((d, d))
        for c in classes:
            Xc = X[y == c]
            mu_c = Xc.mean(axis=0)
            centered = Xc - mu_c
            Sw += centered.T @ centered
            diff = (mu_c - overall_mean)[:, None]
            Sb += Xc.shape[0] * (diff @ diff.T)
        evals, evecs = scipy.linalg.eig(Sb, Sw)
        order = np.argsort(-evals.real)
        W = evecs[:, order[: self.num_dimensions]].real
        return LinearMapper(torch.as_tensor(W, dtype=torch.float32, device=arr.device))
