"""Statistical feature nodes on the flagship path (counterpart of
``keystone_tpu/ops/stats/nodes.py``: ``NormalizeRows`` and
``SignedHellingerMapper``)."""

from __future__ import annotations

import dataclasses

import torch

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.workflow.api import Transformer


@dataclasses.dataclass(eq=False)
class NormalizeRows(Transformer):
    """L2 row normalization with a tiny-norm floor (2.2e-16)."""

    floor: float = 2.2e-16

    def apply(self, x):
        return x / torch.clamp(torch.linalg.vector_norm(x), min=self.floor)

    def apply_batch(self, ds: Dataset) -> Dataset:
        x = ds.padded()
        nrm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return Dataset.from_array(x / torch.clamp(nrm, min=self.floor), n=ds.n)


@dataclasses.dataclass(eq=False)
class SignedHellingerMapper(Transformer):
    """Signed square-root power normalization: sign(x) * sqrt(|x|)."""

    def apply(self, x):
        return torch.sign(x) * torch.sqrt(torch.abs(x))

    def apply_batch(self, ds: Dataset) -> Dataset:
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("signed_hellinger",)
