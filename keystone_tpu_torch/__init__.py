"""keystone-tpu on PyTorch and CUDA: the port of ``keystone_tpu`` to one
NVIDIA H100.

The package mirrors ``keystone_tpu``'s module paths and class names, so
the counterpart of any module sits at the same path here. Plain tensor
code is PyTorch; the three Pallas kernels of the flagship featurize path
are CUDA C++ kernels for ``sm_90a`` under ``csrc/``, built with ``nvcc``
at first use. A kernel wrapper picks the kernel or its plain PyTorch
version from the device of the tensors it is given: CPU tensors take the
plain version, CUDA tensors the kernel, and anything else raises.

The entry points (``build_flagship_featurize_pipeline``,
``FittedPipeline.compiled``, ``CompiledPipeline``) run on ``cuda`` by
default and raise when CUDA is missing; they run on the CPU only when the
caller passes ``device="cpu"``. This package never imports ``jax`` or
``keystone_tpu``.

``python -m keystone_tpu_torch <App> [args]`` runs one of the eight apps
(``-h`` lists them).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "Estimator": "keystone_tpu_torch.workflow",
    "FittedPipeline": "keystone_tpu_torch.workflow",
    "FunctionNode": "keystone_tpu_torch.workflow",
    "LabelEstimator": "keystone_tpu_torch.workflow",
    "Pipeline": "keystone_tpu_torch.workflow",
    "Transformer": "keystone_tpu_torch.workflow",
    "Dataset": "keystone_tpu_torch.parallel.dataset",
    "CompiledPipeline": "keystone_tpu_torch.serving.engine",
    "MicroBatcher": "keystone_tpu_torch.serving",
    "ServingMetrics": "keystone_tpu_torch.serving",
    "build_flagship_featurize_pipeline": "keystone_tpu_torch.serving.featurize",
}


from keystone_tpu_torch._lazy import make_getattr

__getattr__ = make_getattr(__name__, _EXPORTS)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
