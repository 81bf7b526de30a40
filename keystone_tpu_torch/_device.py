"""Device resolution for the port's entry points.

``None`` means ``cuda``. A CUDA device that is not there raises; the CPU
is used only when the caller names it. Resolving a CUDA device also turns
TF32 off for matmuls and cuDNN convolutions: the JAX package pins
float32 ``Precision.HIGHEST`` wherever its tolerances were set, and a
float32 convolution goes through cuDNN in TF32 by default.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "keystone_tpu_torch runs on CUDA by default, and CUDA is not "
                "available here; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
