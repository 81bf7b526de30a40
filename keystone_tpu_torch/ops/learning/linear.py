"""Linear maps and exact least-squares solvers (counterpart of
``keystone_tpu/ops/learning/linear.py``).

Reference: nodes/learning/LinearMapper.scala (LinearMapper/LinearMapEstimator
— mlmatrix NormalEquations) and LocalLeastSquaresEstimator.scala (dual-form
OLS for d >> n). The Gram matrices are float32 products on the data's
device (TF32 off on the card, the JAX package's ``Precision.HIGHEST``);
the small (d, d) or (n, n) system is solved on the host in float64
(``hostsolve.py``), as the reference solves it on one node.

On rows sharded over processes (``Dataset.shard``) the Grams are this
process's rows' plus an ``all_sum``, and every process solves the same
reduced system. The dual solver's (n, n) Gram pairs every row with every
row, so it is built one shard's rows at a time (``global_rows``: those
rows cross processes, as a kernel block's training rows do).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from keystone_tpu_torch.ops.learning.block_ls import _f32_mm
from keystone_tpu_torch.ops.learning.hostsolve import psd_solve_host
from keystone_tpu_torch.parallel.dataset import Dataset, is_sparse, spmm
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import LabelEstimator, Transformer


@dataclasses.dataclass(eq=False)
class LinearMapper(Transformer):
    """x -> x @ W (+ intercept), optionally standard-scaling the input first
    (reference: nodes/learning/LinearMapper.scala:18)."""

    W: Any  # (d, k)
    intercept: Optional[Any] = None  # (k,)
    feature_scaler: Optional[Any] = None  # StandardScalerModel or None

    def apply(self, x):
        if self.feature_scaler is not None:
            x = self.feature_scaler.apply(x)
        out = mm(x, self.W)
        if self.intercept is not None:
            out = out + self.intercept
        return out

    def apply_batch(self, ds: Dataset) -> Dataset:
        """Predictions; sharded rows are predicted where they are."""
        if self.feature_scaler is not None:
            ds = self.feature_scaler.apply_batch(ds)
        out = mm(ds.local(), self.W)
        if self.intercept is not None:
            out = (out + self.intercept) * ds.mask()[:, None]
        return Dataset(arrays=out, n=ds.n, mesh=ds.mesh)


@dataclasses.dataclass(eq=False)
class LinearMapEstimator(LabelEstimator):
    """Exact OLS via normal equations with optional L2: solve
    (AᵀA + λI) W = Aᵀb (reference: LinearMapper.scala:69-116 — mlmatrix
    NormalEquations)."""

    lam: float = 0.0

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        A = data.local()
        b = labels.local_like(data).to(A.device)
        gram, rhs = data.all_sum(_f32_mm(A.T, A), _f32_mm(A.T, b))
        W = psd_solve_host(gram.cpu().numpy(), rhs.cpu().numpy(), self.lam)
        return LinearMapper(torch.as_tensor(W, dtype=A.dtype, device=A.device))

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight,
             network_weight):
        """Exact normal-equations cost (reference:
        LinearMapper.scala:100-115)."""
        flops = n * float(d) * (d + k) / num_machines
        bytes_scanned = n * float(d) / num_machines + float(d) * d
        network = float(d) * (d + k)
        return (
            max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )

    @staticmethod
    def compute_cost(
        data: Dataset, labels: Dataset, lam: float, W, intercept=None
    ) -> float:
        """0.5·‖AW − b‖² + 0.5·λ‖W‖² (reference: LinearMapper.computeCost),
        pad rows masked out when there is an intercept."""
        A = data.local()
        b = labels.local_like(data).to(A.device)
        W = torch.as_tensor(W, device=A.device)
        pred = _f32_mm(A, W)
        if intercept is not None:
            pred = (pred + torch.as_tensor(intercept, device=A.device)) * data.mask()[:, None]
        (res,) = data.all_sum(torch.sum((pred - b) ** 2))
        return float(0.5 * res + 0.5 * lam * torch.sum(W * W))


@dataclasses.dataclass(eq=False)
class LocalLeastSquaresEstimator(LabelEstimator):
    """Dual-form OLS for d >> n: W = Aᵀ (A Aᵀ + λ n I)⁻¹ b (reference:
    nodes/learning/LocalLeastSquaresEstimator.scala:35): the (n, n) Gram on
    the device, its solve and Aᵀα on the host in float64, as in the JAX
    package."""

    lam: float = 0.0

    def fit(self, data: Dataset, labels: Dataset) -> LinearMapper:
        data = data.to_array_mode()
        X = data.local()
        n, per = data.n, data.local_n
        A = X[: data.local_valid]
        shards = range(0, data.padded_n, per)
        # K's columns one shard's valid rows at a time, then its rows from
        # every process; b and K are (n, ·), never X
        K_here = torch.cat([
            _f32_mm(A, data.global_rows(X, lo, lo + per)[: max(0, min(per, n - lo))].T)
            for lo in shards], dim=1)
        K_here = torch.cat([K_here, K_here.new_zeros((per - A.shape[0], n))])
        K = data.global_rows(K_here, 0, data.padded_n)[:n]
        b = data.global_rows(labels.local_like(data).to(X.device), 0, data.padded_n)[:n]
        alpha = psd_solve_host(K.cpu().numpy(), b.cpu().numpy(), self.lam * n)
        lo = data.offset
        (W,) = data.all_sum(torch.as_tensor(A.cpu().numpy().T @ alpha[lo : lo + A.shape[0]],
                                            device=X.device))
        return LinearMapper(W.to(A.dtype))


def rows_times(x, W: torch.Tensor) -> torch.Tensor:
    """``x @ W`` on ``W``'s device in float32, for dense rows, sparse rows
    (CSR, through SpMM) or one 1-D sparse vector (a gather of W's rows)."""
    if x.layout == torch.sparse_coo:
        x = x.coalesce().to(W.device)
        return x.values().to(torch.float32) @ W[x.indices()[0]].to(torch.float32)
    if is_sparse(x):
        return spmm(x.to(W.device), W)
    return mm(x.to(W.device), W)


@dataclasses.dataclass(eq=False)
class SparseLinearMapper(Transformer):
    """Sparse-input linear map (reference:
    nodes/learning/SparseLinearMapper.scala:13). Inputs are 1-D sparse
    vectors or a batch of sparse rows (CSR), moved to ``W``'s device; the
    model stays dense."""

    W: Any  # (d, k)
    intercept: Optional[Any] = None

    def apply(self, x):
        out = rows_times(x, self.W)
        if self.intercept is not None:
            out = out + self.intercept
        return out

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)
