"""ZCA whitening (counterpart of ``keystone_tpu/ops/learning/zca.py``).

Reference: nodes/learning/ZCAWhitener.scala:12,30,37 — fit from a single
stacked sample matrix via LAPACK sgesvd; whitener =
V diag((s²/(n−1) + ε)^−½) Vᵀ; apply = (x − means) · whitener. Here the SVD
is ``torch.linalg.svd`` of the float32 centred sample on its device
(cuSOLVER on the card); the whitener does not depend on the singular
vectors' signs. On rows sharded over processes the means are one
``all_reduce`` and the SVD is of the centred rows' TSQR R factor
(``pca.centered_factor``), which has the same singular values and right
singular vectors, so no row leaves its process.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from keystone_tpu_torch.ops.learning.pca import centered_factor
from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Estimator, Transformer


@dataclasses.dataclass(eq=False)
class ZCAWhitener(Transformer):
    whitener: Any  # (d, d)
    means: Any  # (d,)

    def apply(self, x):
        # works for a (d,) vector or an (m, d) row-major patch matrix
        return mm(x - self.means.to(x.device), self.whitener.to(x.device))

    def apply_batch(self, ds: Dataset) -> Dataset:
        out = self.apply(ds.local())
        out = out * ds.mask()[:, None] if out.ndim == 2 else out
        return Dataset(arrays=out, n=ds.n, mesh=ds.mesh)


@dataclasses.dataclass(eq=False)
class ZCAWhitenerEstimator(Estimator):
    """Fit from the (single) stacked sample matrix (n, d)."""

    eps: float = 0.1

    def fit(self, data) -> ZCAWhitener:
        if not isinstance(data, Dataset):
            return self.fit_single(data)
        means, factor = centered_factor(data, torch.float32)
        return self._whitener(factor, means, data.n)

    def fit_single(self, x: torch.Tensor) -> ZCAWhitener:
        x = torch.as_tensor(x).to(torch.float32)
        means = torch.mean(x, dim=0)
        return self._whitener(x - means, means, x.shape[0])

    def _whitener(self, factor: torch.Tensor, means: torch.Tensor, n: int) -> ZCAWhitener:
        """From the centred rows (or a factor with their Gram) and means."""
        _, s, vt = torch.linalg.svd(factor, full_matrices=False)
        scale = 1.0 / torch.sqrt(s * s / (n - 1.0) + self.eps)
        return ZCAWhitener(mm(vt.T * scale[None, :], vt), means)
