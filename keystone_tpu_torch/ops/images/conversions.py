"""Explicit image representation conversions and round-trips (counterpart
of ``keystone_tpu/ops/images/conversions.py``), as functions on tensors.

Reference: utils/images/ImageConversions.scala — decoded byte buffers
(BGR / ABGR / gray) to the row-major image wrapper
(bufferedImageToWrapper:10), grayscale tripling (grayScaleImageToWrapper:
26), and image -> packed-int RGB export with optional min/max scaling
(imageToBufferedImage:48). An image is a plain (H, W, C) float tensor, so
conversions are tensor ops; the packed-RGB pair gives an exact
export/import round-trip. A function given a tensor runs on its device;
``bytes_to_image`` makes its tensor on ``device`` (``None`` means
``cuda``, raising without it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from keystone_tpu_torch._device import resolve_device


def bytes_to_image(
    data, height: int, width: int, channels: int, order: str = "bgr",
    device: Optional[str] = None,
) -> torch.Tensor:
    """Interleaved decoded bytes -> (H, W, C) float32 image. ``order``
    names the source channel layout ("bgr", "abgr", "rgb", "gray");
    output is always RGB (or single-channel), alpha dropped — the
    Java-decoder layouts ImageConversions.scala:10-24 normalizes."""
    arr = np.frombuffer(bytes(data), np.uint8).astype(np.float32)
    arr = arr.reshape(height, width, channels)
    if order == "bgr":
        if channels != 3:
            raise ValueError("bgr order requires 3 channels")
        arr = arr[:, :, ::-1]
    elif order == "abgr":
        if channels != 4:
            raise ValueError("abgr order requires 4 channels")
        arr = arr[:, :, :0:-1]  # drop alpha, reverse to RGB
    elif order == "gray":
        if channels != 1:
            raise ValueError("gray order requires 1 channel")
    elif order != "rgb":
        raise ValueError(f"unknown channel order {order!r}")
    return torch.as_tensor(np.ascontiguousarray(arr), device=resolve_device(device))


def gray_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """(H, W) or (H, W, 1) -> (H, W, 3) by channel replication
    (ImageConversions.scala:26-37)."""
    if img.dim() == 2:
        img = img[:, :, None]
    if img.shape[-1] != 1:
        raise ValueError(f"expected 1 channel, got {img.shape[-1]}")
    return img.expand(img.shape[:2] + (3,))


def image_to_rgb_ints(img: torch.Tensor, scale: bool = False) -> torch.Tensor:
    """(H, W, 3|1) float image -> (H, W) packed int32 RGB
    (r<<16 | g<<8 | b), optionally min/max-scaled to [0, 255]
    (ImageConversions.scala:48-83)."""
    if img.dim() == 2:
        img = img[:, :, None]
    if img.shape[-1] == 1:
        img = gray_to_rgb(img)
    if scale:
        lo, hi = torch.min(img), torch.max(img)
        img = 255.0 * (img - lo) / torch.clamp(hi - lo, min=1e-12)
    rgb = torch.clamp(img, 0, 255).to(torch.int32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def rgb_ints_to_image(packed: torch.Tensor) -> torch.Tensor:
    """(H, W) packed int32 RGB -> (H, W, 3) float32 — inverse of
    ``image_to_rgb_ints`` (exact for byte-valued images)."""
    r = (packed >> 16) & 0xFF
    g = (packed >> 8) & 0xFF
    b = packed & 0xFF
    return torch.stack([r, g, b], dim=-1).to(torch.float32)


def hwc_to_chw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(2, 0, 1)


def chw_to_hwc(img: torch.Tensor) -> torch.Tensor:
    return img.permute(1, 2, 0)


def vectorize(img: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> flat channel-major vector (all of channel 0, then
    channel 1, ...) — the reference wrappers' vectorized layout
    (utils/images/Image.scala ChannelMajorArrayVectorizedImage)."""
    return hwc_to_chw(img).reshape(-1)


def unvectorize(vec: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    """Inverse of ``vectorize`` given the (H, W, C) shape."""
    h, w, c = shape
    return chw_to_hwc(vec.reshape(c, h, w))
