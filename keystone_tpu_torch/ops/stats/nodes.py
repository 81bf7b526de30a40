"""Statistical feature nodes on the flagship path (counterpart of
``keystone_tpu/ops/stats/nodes.py``: ``NormalizeRows``,
``SignedHellingerMapper`` and ``ColumnSampler``)."""

from __future__ import annotations

import dataclasses

import numpy as np
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
        # sign(x)·sqrt(|x|) with one temporary: multiplying by ±1 is exact,
        # so copysign gives the same values (a zero may keep its sign)
        return torch.abs(x).sqrt_().copysign_(x)

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:  # descriptor matrices of several widths
            return self._bucketed_batch(ds)
        return Dataset.from_array(self.apply(ds.padded()), n=ds.n)

    def eq_key(self):
        return ("signed_hellinger",)


class ColumnSampler(Transformer):
    """Sample ``num_cols`` columns of each (d, m) matrix datum — used to
    subsample per-image descriptor sets before the PCA and GMM fits.

    The indices are drawn on the host, one ``default_rng((seed, counter))``
    per datum in dataset order with the counter running on across calls,
    as in the JAX package, so both draw the same columns. They are applied
    on the data's device: a batch is gathered there, never copied to the
    host."""

    def __init__(self, num_cols: int, seed: int = 0):
        self.num_cols = num_cols
        self.seed = seed
        self._counter = 0

    def _draw(self, m: int) -> np.ndarray:
        # independent draw per datum (the reference samples per image)
        rng = np.random.default_rng((self.seed, self._counter))
        self._counter += 1
        return rng.integers(0, m, self.num_cols)

    def apply(self, m):
        m = torch.as_tensor(m)
        idx = torch.as_tensor(self._draw(m.shape[1]), device=m.device)
        return m[:, idx]

    def apply_batch(self, ds: Dataset) -> Dataset:
        if not ds.is_array:
            return ds.map(self.apply)
        x = ds.array()  # (n, d, m)
        n, d, m = x.shape
        idx = np.stack([self._draw(m) for _ in range(n)]) if n else (
            np.zeros((0, self.num_cols), np.int64)
        )
        idx = torch.as_tensor(idx, device=x.device)
        out = torch.gather(x, 2, idx[:, None, :].expand(n, d, self.num_cols))
        return Dataset.from_array(out, n=n)

    def eq_key(self):
        return ("column_sampler", self.num_cols, self.seed)
