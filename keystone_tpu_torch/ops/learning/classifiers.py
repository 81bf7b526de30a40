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
parameters' device. On dense rows sharded over processes
(``Dataset.shard``) the labels are the label dataset's rows beside this
process's, and the counts, sums, losses and gradients are this process's
rows' plus an ``all_sum``; every process then holds the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import scipy.linalg
import torch

from keystone_tpu_torch.ops.learning.lbfgs import host_vg, run_lbfgs, run_lbfgs_device
from keystone_tpu_torch.ops.learning.linear import rows_times
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.dataset import (
    Dataset,
    all_sum,
    csr_transpose,
    is_sparse,
    on_every_shard,
    spmm,
)
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
        """Scores; sharded rows are scored where they are."""
        scores = self.pi + rows_times(ds.local(), self._theta_t())
        mask = ds.mask().to(scores.device)
        return Dataset(arrays=scores * mask[:, None], n=ds.n, mesh=ds.mesh)


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
        data = data.to_array_mode()
        # float labels train as their integer part, as in the JAX package
        y = labels.local_like(data).reshape(-1)[: data.local_valid].to(torch.int32)
        x = data.local().to(y.device)
        onehot = _onehot(y, self.num_classes)
        bad = torch.any((y < 0) | (y >= self.num_classes))
        onehot = torch.where(bad, torch.full_like(onehot, float("nan")), onehot)
        ys = _pad_rows(onehot, x.shape[0])  # pad rows of x are zero
        if is_sparse(x):
            counts = spmm(csr_transpose(x), ys).T
        else:
            counts = mm(ys.T, x)
        # a NaN of one process's bad label reaches every process's sums
        counts, class_counts = data.all_sum(counts, onehot.sum(dim=0))
        pi = torch.log(class_counts + self.lam) - np.log(
            labels.n + self.num_classes * self.lam
        )
        totals = torch.sum(counts, dim=1, keepdim=True)
        theta = torch.log(counts + self.lam) - torch.log(totals + self.lam * counts.shape[1])
        return NaiveBayesModel(pi, theta.contiguous())


def _logistic_vg(W, x, onehot, mask, n, reg, xt=None, mesh=None):
    """Softmax cross-entropy mean loss + L2 and its gradient, the
    ``vg(W, *data)`` the L-BFGS drivers take. ``xt`` is the CSR of ``xᵀ``
    for sparse ``x``; ``x`` is this process's rows when ``mesh`` is given,
    and the sums are added over the shards."""
    logits = spmm(x, W) if xt is not None else mm(x, W)
    logz = torch.logsumexp(logits, dim=1)
    ll = torch.sum((logz - torch.sum(logits * onehot, dim=1)) * mask)
    p = torch.exp(logits - logz[:, None]) * mask[:, None]
    g = spmm(xt, p - onehot) if xt is not None else mm(x.T, p - onehot)
    ll, g = all_sum(mesh, ll, g)
    return ll / n + 0.5 * reg * torch.sum(W * W), g / n + reg * W


@dataclasses.dataclass(eq=False)
class LogisticRegressionModel(Transformer):
    """argmax-of-logits classifier (reference:
    LogisticRegressionModel.scala:19, MLlib model.predict)."""

    W: Any  # (d, k)

    def apply(self, x):
        return torch.argmax(rows_times(x, self.W), dim=-1)

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset(arrays=torch.argmax(rows_times(ds.local(), self.W), dim=-1), n=ds.n,
                       mesh=ds.mesh)


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
        data = data.to_array_mode()
        y_dev = labels.local_like(data).reshape(-1)[: data.local_valid]
        y = y_dev.cpu().numpy().astype(np.int64)
        bad = bool(y.size and (y.min() < 0 or y.max() >= self.num_classes))
        # every process raises together (one that went on would wait in
        # the fit's first all_reduce)
        if not on_every_shard(data.mesh, not bad, y_dev.device):
            # an eye(k)[y] would wrap negatives (e.g. -1/+1 binary labels)
            # into valid classes and corrupt the fit
            raise ValueError(
                f"labels must be class ids in [0, {self.num_classes}); "
                + (f"got range [{y.min()}, {y.max()}]" if bad else "another shard's are not")
            )
        dev = y_dev.device
        x = data.local().to(dev)
        n = data.n
        d = x.shape[1]
        k = self.num_classes
        onehot = _pad_rows(torch.as_tensor(np.eye(k, dtype=np.float32)[y], device=dev),
                           x.shape[0])
        mask = data.mask().to(dev)
        xt = csr_transpose(x) if is_sparse(x) else None
        vg_data = (x, onehot, mask, float(n), float(self.reg_param), xt, data.mesh)
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
    float64 on the host; the projection on the data's device. On sharded
    rows the class counts and sums, then the within-class scatter about
    the class means, are this process's rows' plus an ``all_sum``."""

    num_dimensions: int

    def fit(self, data: Dataset, labels: Dataset):
        from keystone_tpu_torch.ops.learning.linear import LinearMapper

        data = data.to_array_mode()
        arr = data.local()
        here = data.local_valid
        X = arr[:here].detach().cpu().numpy().astype(np.float64)
        y = labels.local_like(data).reshape(-1)[:here].cpu().numpy().astype(np.int64)
        classes = np.unique(y)
        if data.is_sharded:
            classes = np.unique(np.concatenate(mesh_lib.all_gather_objects(classes, data.mesh)))
        d = X.shape[1]

        def summed(*parts):  # float64 host sums over every shard's rows
            got = data.all_sum(*(torch.as_tensor(p, device=arr.device) for p in parts))
            return [g.cpu().numpy() for g in got]

        counts, sums = summed(np.array([np.sum(y == c) for c in classes], np.float64),
                              np.stack([X[y == c].sum(axis=0) for c in classes]))
        means = sums / counts[:, None]
        overall_mean = sums.sum(axis=0) / data.n
        (Sw,) = summed(sum((X[y == c] - means[i]).T @ (X[y == c] - means[i])
                           for i, c in enumerate(classes)))
        Sb = np.zeros((d, d))
        for i in range(len(classes)):
            diff = (means[i] - overall_mean)[:, None]
            Sb += counts[i] * (diff @ diff.T)
        evals, evecs = scipy.linalg.eig(Sb, Sw)
        order = np.argsort(-evals.real)
        W = evecs[:, order[: self.num_dimensions]].real
        return LinearMapper(torch.as_tensor(W, dtype=torch.float32, device=arr.device))
