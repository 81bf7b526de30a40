"""PCA: the transformers, local SVD, TSQR, and the cost-model-selected
column variant, and the randomized sketch (counterpart of
``keystone_tpu/ops/learning/pca.py``).

Every fit runs on the data's device: the SVD and QR are
``torch.linalg``'s (cuSOLVER on the card), and the sign convention removes
the SVD's sign freedom, so the card and the CPU give the same matrix.
The local and the TSQR PCA take rows sharded over processes
(``Dataset.shard``): the column means are one ``all_reduce`` and R one
tree over the shards (``parallel/linalg.tsqr_r``), whose SVD gives the
centred rows' right singular vectors, so no row leaves its process (the
local PCA takes the rows themselves where one shard holds them all);
the column variant shards its columns over
the current mesh, as the JAX package's does. So does the sketch PCA: its
tall QRs are trees (``tsqr_q``) and its products over rows (AᵀQ, QᵀA)
sums over the shards (``all_sum``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from keystone_tpu_torch.ops.learning.cost import (
    H100_CPU_WEIGHT,
    H100_MEM_WEIGHT,
    H100_NETWORK_WEIGHT,
    CostModel,
)
from keystone_tpu_torch.parallel import linalg as plinalg
from keystone_tpu_torch.parallel import mesh as mesh_lib
from keystone_tpu_torch.parallel.dataset import Dataset, all_sum
from keystone_tpu_torch.utils.chunks import map_rows
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Estimator, Transformer
from keystone_tpu_torch.workflow.node_optimization import Optimizable


def enforce_matlab_pca_sign_convention(pca: torch.Tensor) -> torch.Tensor:
    """The largest-|element| entry of each column gets a positive sign."""
    col_maxs = torch.amax(pca, dim=0)
    abs_col_maxs = torch.amax(torch.abs(pca), dim=0)
    signs = torch.where(col_maxs == abs_col_maxs, 1.0, -1.0).to(pca.dtype)
    return pca * signs[None, :]


@dataclasses.dataclass(eq=False)
class PCATransformer(Transformer):
    """x -> pca_matᵀ x for vectors."""

    pca_mat: Any  # (d, dims)

    def apply(self, x):
        return mm(x, self.pca_mat)

    def apply_batch(self, ds: Dataset) -> Dataset:
        """This process's rows, projected (pad rows stay zero)."""
        ds = ds.to_array_mode()
        return Dataset(arrays=mm(ds.local(), self.pca_mat), n=ds.n, mesh=ds.mesh)


@dataclasses.dataclass(eq=False)
class BatchPCATransformer(Transformer):
    """(d, m) descriptor matrix -> (dims, m): ``pca_matᵀ · in``."""

    pca_mat: Any  # (d, dims) tensor

    def apply(self, m):
        return mm(self.pca_mat.T, m)

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:  # descriptor matrices of several widths
            return self._bucketed_batch(ds)
        # in chunks of images: a training set's (n, d, m) descriptors
        # are the largest tensor of a fit
        out = map_rows(
            lambda x: torch.einsum("dk,ndm->nkm", self.pca_mat, x), ds.padded()
        )
        return Dataset.from_array(out, n=ds.n)


def _centered_rows(data: Dataset, dtype: Optional[torch.dtype] = None):
    """``data`` in array mode, the column means of its valid rows over
    every shard, and this process's rows centred (pad rows zero); ``dtype``
    casts the rows first."""
    ds = data.to_array_mode()
    x = ds.local()
    x = x.to(dtype) if dtype is not None else x
    (s,) = ds.row_sum(x)
    mu = s / ds.n
    return ds, mu, (x - mu) * ds.mask().to(x.device, x.dtype)[:, None]


def centered_factor(data: Dataset, dtype: Optional[torch.dtype] = None):
    """The column means of ``data``'s valid rows over every shard, and a
    matrix with the centred rows' Gram, so their singular values and right
    singular vectors: the centred rows themselves where one shard holds
    them all, else their TSQR R factor (``tsqr_r``), so that no row leaves
    its process. ``dtype`` casts the rows first."""
    ds, mu, centered = _centered_rows(data, dtype)
    if ds.is_sharded and mesh_lib.n_data_shards(ds.mesh) > 1:
        return mu, plinalg.tsqr_r(centered, ds.mesh)
    return mu, centered


def _compute_pca(data: Dataset, dims: int) -> torch.Tensor:
    """Center, SVD, sign convention, truncate."""
    vt = torch.linalg.svd(centered_factor(data)[1], full_matrices=False).Vh
    return enforce_matlab_pca_sign_convention(vt.T)[:, :dims]


@dataclasses.dataclass(eq=False)
class PCAEstimator(Estimator, CostModel):
    """Local PCA: one SVD of the whole sample (of its TSQR R factor when
    its rows are sharded over processes)."""

    dims: int

    def fit(self, data: Dataset) -> PCATransformer:
        return PCATransformer(_compute_pca(data, self.dims))

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight,
             network_weight):
        # collect everything to one place
        flops = float(n) * d * d
        bytes_scanned = float(n) * d
        network = float(n) * d
        return (
            max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )


@dataclasses.dataclass(eq=False)
class DistributedPCAEstimator(Estimator, CostModel):
    """PCA through TSQR: R of the centered matrix, then the SVD of R (on
    every process from the same R when the rows are sharded)."""

    dims: int

    def fit(self, data: Dataset) -> PCATransformer:
        ds, _, centered = _centered_rows(data)
        r = plinalg.tsqr_r(centered, ds.mesh)
        vt = torch.linalg.svd(r, full_matrices=False).Vh
        pca = enforce_matlab_pca_sign_convention(vt.T)
        return PCATransformer(pca[:, : self.dims])

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight,
             network_weight):
        # n d²/m + d³ log m
        flops = float(n) * d * d / num_machines + float(d) ** 3 * max(
            np.log2(num_machines), 1.0
        )
        bytes_scanned = float(n) * d / num_machines
        network = float(d) * d * max(np.log2(num_machines), 1.0)
        return (
            max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )


def approximate_pca(A: torch.Tensor, omega: torch.Tensor, q: int, dims: int,
                    mesh: Optional[mesh_lib.Mesh] = None) -> torch.Tensor:
    """The randomized sketch PCA of a centered (n, d) ``A`` given its test
    matrix ``omega`` (d, l): the range finder with ``q`` power iterations
    (Halko, Martinsson and Tropp, algorithms 4.4 and 5.1), the SVD of the
    small projection, the sign convention, the first ``dims`` columns. A
    plain function of its inputs, so that a test can hand it the JAX
    package's draw. ``A`` is this process's rows when ``mesh`` is given:
    Q's rows stay beside A's, and AᵀQ and QᵀA are summed over the shards."""
    Q = plinalg.tsqr_q(mm(A, omega), mesh)
    for _ in range(q):  # power iterations, for a slowly decaying spectrum
        (AtQ,) = all_sum(mesh, mm(A.T, Q))
        Z = torch.linalg.qr(AtQ).Q
        Q = plinalg.tsqr_q(mm(A, Z), mesh)
    (B,) = all_sum(mesh, mm(Q.T, A))
    vt = torch.linalg.svd(B, full_matrices=False).Vh
    return enforce_matlab_pca_sign_convention(vt.T)[:, :dims]


@dataclasses.dataclass(eq=False)
class ApproximatePCAEstimator(Estimator, CostModel):
    """Randomized sketch PCA (ApproximatePCA.scala:22,37,67): an (n,
    dims + p) sketch with ``q`` power iterations. The JAX package draws its
    Gaussian test matrix with ``jax.random``, which PyTorch cannot
    reproduce; here it comes from a CPU ``torch.Generator`` seeded by
    ``seed`` (the same draw on every device and every process), then
    ``approximate_pca``, on sharded rows too."""

    dims: int
    p: int = 10  # oversampling
    q: int = 2  # power iterations
    seed: int = 0

    def fit(self, data: Dataset) -> PCATransformer:
        ds = data.to_array_mode()
        x = ds.local()
        mask = ds.mask()
        (s,) = ds.row_sum(x)
        mu = s / ds.n
        A = (x - mu) * mask[:, None]
        d = A.shape[1]
        l = min(self.dims + self.p, d)
        omega = torch.randn((d, l), generator=torch.Generator().manual_seed(self.seed))
        return PCATransformer(approximate_pca(A, omega.to(A.device), self.q, self.dims, ds.mesh))

    def cost(self, n, d, k, sparsity, num_machines, cpu_weight, mem_weight,
             network_weight):
        l = self.dims + self.p
        flops = float(n) * d * l * (1 + self.q) / num_machines
        bytes_scanned = float(n) * d / num_machines
        network = float(d) * l
        return (
            max(cpu_weight * flops, mem_weight * bytes_scanned)
            + network_weight * network
        )


def matrix_columns(data: Dataset) -> Dataset:
    """A dataset of (d, m) descriptor matrices as one (N, d) array of
    their columns, in dataset order, concatenated on the data's device."""
    if data.is_array:
        x = data.array()  # (n, d, m)
        return Dataset.from_array(x.transpose(1, 2).reshape(-1, x.shape[1]))
    cols = [torch.as_tensor(m).T for m in data.items()]
    return Dataset.from_array(torch.cat(cols, dim=0))


@dataclasses.dataclass(eq=False)
class LocalColumnPCAEstimator(Estimator, CostModel):
    """Column-wise local PCA over matrix items."""

    dims: int

    def fit(self, data: Dataset) -> BatchPCATransformer:
        t = PCAEstimator(self.dims).fit(matrix_columns(data))
        return BatchPCATransformer(t.pca_mat)

    def cost(self, *a, **kw):
        return PCAEstimator(self.dims).cost(*a, **kw)


@dataclasses.dataclass(eq=False)
class DistributedColumnPCAEstimator(Estimator, CostModel):
    """Column-wise PCA through TSQR, the columns sharded over the current
    mesh (JAX's ``pca.py:212-217``)."""

    dims: int

    def fit(self, data: Dataset) -> BatchPCATransformer:
        t = DistributedPCAEstimator(self.dims).fit(matrix_columns(data).shard())
        return BatchPCATransformer(t.pca_mat)

    def cost(self, *a, **kw):
        return DistributedPCAEstimator(self.dims).cost(*a, **kw)


@dataclasses.dataclass(eq=False)
class ColumnPCAEstimator(Estimator, Optimizable):
    """Cost-model choice between local and TSQR column PCA, priced at
    ``num_machines`` machines when given, else at the current mesh's data
    shards (one for one process)."""

    dims: int
    num_machines: Optional[int] = None

    def _options(self):
        return [
            LocalColumnPCAEstimator(self.dims),
            DistributedColumnPCAEstimator(self.dims),
        ]

    def fit(self, data: Dataset):
        # consult the cost model eagerly (the graph-level
        # NodeOptimizationRule replaces this node when it can sample)
        return self.optimize([data], data.n).fit(data)

    def optimize(self, samples, n_total: int):
        sample: Dataset = samples[0]
        first = sample.first()
        d = first.shape[0]
        cols_per_item = first.shape[1] if first.ndim > 1 else 1
        n = max(n_total, sample.n) * cols_per_item
        machines = self.num_machines or mesh_lib.n_data_shards()
        return min(
            self._options(),
            key=lambda o: o.cost(
                n, d, self.dims, 1.0, machines,
                H100_CPU_WEIGHT, H100_MEM_WEIGHT, H100_NETWORK_WEIGHT,
            ),
        )
