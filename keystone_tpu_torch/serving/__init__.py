"""Serving subsystem (counterpart of ``keystone_tpu/serving/``).

- ``CompiledPipeline`` (engine.py): bucketed execution with one CUDA
  graph per bucket, captured at ``warmup`` (or a bucket's first
  dispatch) and replayed on every dispatch; pinned host staging and a
  copy stream for the upload.
- ``MicroBatcher`` (batching.py): coalesces single-example ``submit()``
  requests into spec-homogeneous windows under a max-latency deadline,
  with ``swap_engine()`` for live engine replacement.
- ``LanePipeline`` / ``HostBufferPool`` (pipeline.py): the staged lane
  behind ``MicroBatcher(pipeline_depth=N)`` — host-prep, upload, compute
  and deliver on their own threads behind bounded queues.
- ``ServingMetrics`` (metrics.py): per-bucket capture/dispatch counts,
  request sizes, latency percentiles, per-stage pipeline series;
  registered into ``observability.registry``.
- ``suggest_buckets`` / ``padding_waste`` (autoscale.py): the bucket set
  that minimizes padding over the observed request sizes.
- ``build_flagship_featurize_pipeline`` (featurize.py): the flagship
  SIFT+LCS→FV featurize chain.
- the AOT store (aot.py) and model sharding (sharding.py).
- the serving bench's rows (bench.py): ``python -m keystone_tpu_torch
  serve-bench``.
"""

from keystone_tpu_torch._lazy import make_getattr

_EXPORTS = {
    "CompiledPipeline": "keystone_tpu_torch.serving.engine",
    "HostBufferPool": "keystone_tpu_torch.serving.pipeline",
    "HostFeaturize": "keystone_tpu_torch.serving.pipeline",
    "LanePipeline": "keystone_tpu_torch.serving.pipeline",
    "MicroBatcher": "keystone_tpu_torch.serving.batching",
    "ServingMetrics": "keystone_tpu_torch.serving.metrics",
    "padding_waste": "keystone_tpu_torch.serving.autoscale",
    "suggest_buckets": "keystone_tpu_torch.serving.autoscale",
}

__all__ = sorted(_EXPORTS)

__getattr__ = make_getattr(__name__, _EXPORTS)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
