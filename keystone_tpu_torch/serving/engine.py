"""Bucketed execution of a ``FittedPipeline`` (counterpart of
``keystone_tpu/serving/engine.py`` ``CompiledPipeline``).

A ``CompiledPipeline`` fixes a small set of row buckets, zero-pads each
incoming batch up to the smallest covering bucket and dispatches the
pipeline's batched apply path on that bucket; batches larger than the
largest bucket are chunked through it. Zero pad rows are safe by the
``Dataset`` padding discipline; outputs are sliced back to the valid rows.
Fixed buckets keep the set of kernel shapes the server ever launches
small, as the JAX engine's bounded compiles do.

``featurize=`` puts a second fitted pipeline (e.g. the flagship
SIFT+LCS→FV chain) in front of the model: callers send raw examples
(uint8 images), which are padded on the host and copied to the device
once per dispatch.

Not yet ported: AOT executables, sharding, metrics, input donation and
the host/upload/compute stage split.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.observability.tracing import get_tracer
from keystone_tpu_torch.parallel.dataset import Dataset, _leading_dim, _tree_map

DEFAULT_BUCKETS = (8, 64, 512)


class CompiledPipeline:
    """A ``FittedPipeline`` behind a fixed set of batch shapes.

    Parameters
    ----------
    pipeline:  the fitted (transformer-only) pipeline, with its parameters
               on ``device``.
    buckets:   row buckets; a batch of n rows dispatches the smallest
               bucket >= n, and larger batches are chunked through the
               biggest.
    featurize: optional fitted featurize pipeline run in front of
               ``pipeline`` on every dispatch: callers send raw examples.
    device:    where the staged batches go; ``None`` means ``cuda`` and
               raises when CUDA is missing.
    """

    def __init__(
        self,
        pipeline,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        *,
        featurize: Any = None,
        device=None,
        name: Optional[str] = None,
    ):
        if not buckets:
            raise ValueError("need at least one bucket")
        if any(b <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive: {buckets}")
        self.device = resolve_device(device)
        self.pipeline = pipeline
        self.featurize = featurize
        self.name = name or f"engine-{id(self):x}"
        self.buckets: Tuple[int, ...] = tuple(sorted(set(int(b) for b in buckets)))

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket covering ``n`` rows (callers chunk above the
        largest bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the largest bucket "
            f"{self.max_bucket}; chunk it (engine.apply does)"
        )

    def _stage(self, tree: Any, rows: int, bucket: int) -> Any:
        """Pad a tensor (or tuple of tensors) up to ``bucket`` rows with
        zeros and place it on the engine's device."""
        pad = bucket - rows

        def pad_leaf(a):
            if not isinstance(a, torch.Tensor):
                a = torch.as_tensor(np.asarray(a))
            if pad:
                a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
            return a.to(self.device)

        return _tree_map(pad_leaf, tree)

    def _run_bucket(self, staged: Any) -> Any:
        if self.featurize is not None:
            staged = self.featurize._batch_run(staged)
        return self.pipeline._batch_run(staged)

    def apply(self, data: Any, sync: bool = False) -> Any:
        """Serve one batch: pad to the covering bucket (chunking through
        the largest bucket when oversized), dispatch, and return outputs
        sliced to the valid rows, on the engine's device. ``sync=True``
        waits for the device to finish."""
        if isinstance(data, Dataset):
            rows = data.n
            tree = data.array()
        else:
            tree = data
            rows = _leading_dim(tree)
        if rows == 0:
            raise ValueError("cannot serve an empty batch")
        outs: List[Any] = []
        start = 0
        while start < rows:
            take = min(self.max_bucket, rows - start)
            chunk = _tree_map(lambda a: a[start : start + take], tree)
            outs.append(self._dispatch(chunk, take))
            start += take
        result = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return result

    def _dispatch(self, chunk: Any, rows: int) -> Any:
        bucket = self.bucket_for(rows)
        with get_tracer().span(
            "serving.dispatch", engine=self.name, bucket=bucket, rows=rows
        ):
            out = self._run_bucket(self._stage(chunk, rows, bucket))
            return out[:rows]

    __call__ = apply
