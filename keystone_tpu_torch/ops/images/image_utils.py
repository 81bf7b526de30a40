"""Image utility functions (counterpart of
``keystone_tpu/ops/images/image_utils.py``), on tensors.

Reference: utils/images/ImageUtils.scala:16-399 — loadImage, toGrayScale,
mapPixels, crop, pixelCombine, separable conv2D, splitChannels,
flipImage/flipHorizontal. Images are ``A[x, y, c]`` float tensors; a
function runs on its input's device, and ``load_image`` puts the decoded
image on ``device`` (``None`` means ``cuda``, raising without it).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device
from keystone_tpu_torch.ops.images.core import GRAYSCALE_WEIGHTS
from keystone_tpu_torch.ops.images.daisy import _conv2d_same


def load_image(path: str, device: Optional[str] = None) -> Optional[torch.Tensor]:
    """Decode an image file to an (x, y, 3) float32 tensor through PIL
    (reference: ImageUtils.loadImage via ImageIO); ``None`` when PIL
    cannot read it."""
    from PIL import Image as PILImage

    dev = resolve_device(device)
    try:
        img = PILImage.open(path).convert("RGB")
    except Exception:
        return None
    return torch.as_tensor(np.asarray(img, np.float32), device=dev)


def to_gray_scale(img: torch.Tensor) -> torch.Tensor:
    """MATLAB rgb2gray weights (reference: ImageUtils.toGrayScale:73)."""
    w = torch.tensor(GRAYSCALE_WEIGHTS, dtype=torch.float32, device=img.device)
    return (img.to(torch.float32) @ w)[..., None]


def map_pixels(img: torch.Tensor, fn: Callable) -> torch.Tensor:
    return fn(img)


def crop(img: torch.Tensor, start_x: int, start_y: int, end_x: int,
         end_y: int) -> torch.Tensor:
    return img[start_x:end_x, start_y:end_y]


def pixel_combine(a: torch.Tensor, b: torch.Tensor,
                  fn: Callable = torch.add) -> torch.Tensor:
    return fn(a, b)


def split_channels(img: torch.Tensor) -> List[torch.Tensor]:
    return [img[:, :, c : c + 1] for c in range(img.shape[2])]


def conv2d(img: torch.Tensor, x_filter: Sequence[float],
           y_filter: Sequence[float]) -> torch.Tensor:
    """Separable same-size convolution with the reference's asymmetric
    zero padding (ImageUtils.conv2D:226), each channel on its own."""
    squeeze = img.dim() == 3 and img.shape[2] == 1
    x = img[:, :, 0] if squeeze else img
    if x.dim() == 3:
        return _conv2d_same(x.movedim(2, 0), x_filter, y_filter).movedim(0, 2)
    out = _conv2d_same(x, x_filter, y_filter)
    return out[:, :, None] if squeeze else out


def flip_horizontal(img: torch.Tensor) -> torch.Tensor:
    """Mirror along the y (column) axis."""
    return img.flip(1)


def flip_image(img: torch.Tensor) -> torch.Tensor:
    """Flip both spatial axes (reference: ImageUtils.flipImage — used to
    flip convolution filters for MATLAB convnd comparability)."""
    return img.flip(0, 1)
