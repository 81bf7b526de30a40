"""Block linear model, apply path (counterpart of
``keystone_tpu/ops/learning/block_ls.py`` ``BlockLinearMapper``; its
block least-squares solvers are not ported yet — the flagship's weighted
solver is ``weighted_ls.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from keystone_tpu_torch.parallel.dataset import Dataset
from keystone_tpu_torch.utils.precision import mm
from keystone_tpu_torch.workflow.api import Transformer


@dataclasses.dataclass(eq=False)
class BlockLinearMapper(Transformer):
    """Applies the block-solved linear model, stored as one (D, k) matrix
    so apply is one matmul."""

    W: Any  # (D, k)
    block_size: int
    feature_mean: Optional[Any] = None  # (D,)
    label_mean: Optional[Any] = None  # (k,)
    explicit_intercept: Optional[Any] = None  # (k,)
    solver_info: Optional[dict] = None  # solver diagnostics (the weighted
    # solver's PCG exit residual and iteration count)

    @property
    def intercept(self):
        if self.explicit_intercept is not None:
            return self.explicit_intercept
        if self.label_mean is None:
            return None
        if self.feature_mean is None:
            return self.label_mean
        return self.label_mean - mm(self.feature_mean, self.W)

    def apply(self, x):
        out = mm(x, self.W)
        icpt = self.intercept
        return out if icpt is None else out + icpt

    def apply_batch(self, ds: Dataset) -> Dataset:
        out = mm(ds.padded(), self.W)
        icpt = self.intercept
        if icpt is not None:
            # keep pad rows zero
            out = (out + icpt) * ds.mask()[:, None]
        return Dataset.from_array(out, n=ds.n)
