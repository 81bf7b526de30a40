"""PCA apply path (counterpart of ``keystone_tpu/ops/learning/pca.py``
``BatchPCATransformer``; the estimators wait for the training slice)."""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Transformer


@dataclasses.dataclass(eq=False)
class BatchPCATransformer(Transformer):
    """(d, m) descriptor matrix -> (dims, m): ``pca_matᵀ · in``."""

    pca_mat: Any  # (d, dims) tensor

    def apply(self, m):
        return mm(self.pca_mat.T, m)

    def apply_batch(self, ds: Dataset) -> Dataset:
        x = ds.padded()  # (n, d, m)
        return Dataset.from_array(
            torch.einsum("dk,ndm->nkm", self.pca_mat, x), n=ds.n
        )
